"""Sparse / embedding parallelism (``paddle_tpu/parallel/sparse.py``).

Reference: SelectedRows sparse grads (framework/selected_rows.h), row-sparse
parameters (math/SparseRowMatrix) and the pserver sparse modes.  On a mesh
the table is row-sharded over an axis: each rank keeps its block of rows,
and the Executor's ``lookup_table`` rule looks up the ids its block holds
and sums the partial rows over the axis (``parallel/collectives.py``).
The compressed (rows, values) form is the wire format the parameter-server
path (``distributed``) sends instead of the full table.
"""

import torch

from .api import P, shard_parameter

__all__ = ["row_shard_embedding", "sparse_rows_from_grad",
           "apply_sparse_rows"]


def row_shard_embedding(param, mesh_axis="tp"):
    """Annotate an embedding table [vocab, dim] as row-sharded: each rank
    owns vocab/axis_size contiguous rows."""
    return shard_parameter(param, P(mesh_axis, None))


def sparse_rows_from_grad(grad, ids, vocab_size):
    """Compress a dense embedding gradient into SelectedRows form
    ``(rows, values)``: ``rows`` the distinct ids (ascending), then -1
    padding up to the number of ids, and ``values`` each row's summed
    gradient (zeros on the padding) — the reference's fixed-size
    ``jnp.unique(..., size=n, fill_value=-1)`` layout."""
    del vocab_size
    flat = ids.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    g = grad.reshape(n, -1)
    values = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device)
    values.index_add_(0, inv, g)
    rows = torch.full((n,), -1, dtype=torch.int32, device=flat.device)
    rows[:uniq.shape[0]] = uniq.to(torch.int32)
    return rows, values


def apply_sparse_rows(table, rows, values, lr):
    """SGD apply of SelectedRows onto a dense table, out of place (the
    pserver-side ``doOperation`` of the sparse path); -1 rows are
    padding."""
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows)).to(torch.int64)
    update = torch.where(valid[:, None], values * lr,
                         torch.zeros_like(values))
    return table.index_add(0, safe, -update.to(table.dtype))
