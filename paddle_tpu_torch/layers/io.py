"""Data layers (``paddle_tpu/layers/io.py``: ``data``, ``sparse_data``)."""

from ..core.program import IDS_SUFFIX, VALS_SUFFIX, default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         main_program=None, stop_gradient=True):
    """Declare an input variable.

    ``append_batch_size=True`` prepends a batch dim of -1 (resolved at feed
    time from the actual minibatch).  With ``lod_level > 0`` the variable
    is a padded sequence batch and its shadow ``<name>@LENGTH`` int32 var
    is created alongside; ``lod_level == 2`` adds ``<name>@SUBLENGTH``.
    """
    prog = main_program or default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = prog.global_block().create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        is_data=True,
        stop_gradient=stop_gradient,
    )
    if lod_level > 0:
        var.length_var()
    if lod_level > 1:
        var.sub_length_var()
    return var


def sparse_data(name, dim, dtype="float32", lod_level=0, main_program=None):
    """Declare a sparse input slot of vocabulary size ``dim`` (the
    reference's ``sparse_binary_vector`` / ``sparse_float_vector``
    slots, never densified).

    The slot feeds as two padded shadow arrays, ``<name>@IDS`` int
    ``[b, nnz]`` (0-padded) and ``<name>@VALS`` ``[b, nnz]`` (0.0-padded;
    all ones for a binary slot), which ``DataFeeder`` fills; ``fc`` on
    the returned handle lowers to ``sparse_fc``, whose cost is O(nnz),
    not O(dim).  The handle itself (shape ``[-1, dim]``) is never fed.
    ``lod_level=1`` declares a sequence of sparse vectors: the shadow
    arrays gain a time axis and ``<name>@LENGTH`` the lengths."""
    prog = main_program or default_main_program()
    shape = [-1, -1, int(dim)] if lod_level else [-1, int(dim)]
    block = prog.global_block()
    var = block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        is_data=True, stop_gradient=True,
    )
    var.sparse_slot = True
    inner = [-1, -1] if lod_level else [-1]
    block.create_var(name=name + IDS_SUFFIX, shape=inner + [-1],
                     dtype="int64", is_data=True, stop_gradient=True)
    block.create_var(name=name + VALS_SUFFIX, shape=inner + [-1],
                     dtype=dtype, is_data=True, stop_gradient=True)
    if lod_level > 0:
        var.length_var()
    return var
