"""Data layers (``paddle_tpu/layers/io.py``: ``data``)."""

from ..core.program import default_main_program


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
