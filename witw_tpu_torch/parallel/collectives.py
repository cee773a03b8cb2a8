"""Collectives across the processes of a ``torch.distributed`` group: the
explicit form of what GSPMD inserts into witw_tpu's sharded programs, and of
``jax.experimental.multihost_utils``' ``broadcast_one_to_all`` and
``process_allgather``.

Every function is the identity (or a plain copy) in one process, so the
sharded paths call them unconditionally. Across processes every process
must call each of them, in the same order, with tensors of the same shape
and dtype (``allgather_rows`` alone takes a different row count per process).

Each collective runs on a copy where the backend takes it (:func:`stage_device`)
and its result goes back to the caller's device: the Gloo backend's support
for CUDA tensors is partial (``all_gather`` and ``reduce_scatter`` take
none), so under Gloo every copy is on the host; NCCL takes only CUDA
tensors, so under NCCL every copy, a host tensor's too, is on this
process's current CUDA device (``initialize_distributed`` sets it).
``gather_rows`` is built on a SUM ``all_reduce`` alone:
each process writes its rows into a zeroed global buffer, and x + 0 is exact,
so the gathered rows are bit-identical on every process.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without
    one (``jax.process_index``)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The processes in the ``torch.distributed`` group, 1 without one
    (``jax.process_count``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


# bf16 and f16 travel as f32 (exact both ways): Gloo's reductions do not
# take every 16-bit float type.
_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def stage_device() -> torch.device:
    """Where the group's backend takes a collective's tensors: the host
    under Gloo, this process's current CUDA device under NCCL."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` on :func:`stage_device`; 16-bit floats
    widened."""
    return t.detach().to(stage_device(), _WIDEN.get(t.dtype, t.dtype), copy=True).contiguous()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``t`` over the processes, on ``t``'s device
    in ``t``'s dtype (``t`` itself in one process). No autograd."""
    if process_count() == 1:
        return t
    buf = _staged(t)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device, t.dtype)


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (same shape everywhere) stacked in process
    order: [process_count, *t.shape] on ``t``'s device."""
    if process_count() == 1:
        return t[None]
    buf = _staged(t)
    out = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(out, buf)
    return torch.stack(out).to(t.device, t.dtype)


def allgather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` concatenated along the first axis in process
    order; the row counts may differ between processes, the other axes not."""
    if process_count() == 1:
        return t
    counts = process_allgather(torch.tensor([t.shape[0]], dtype=torch.int64)).view(-1).tolist()
    top = max(counts)
    pad = t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))
    every = process_allgather(torch.cat([t, pad]))
    return torch.cat([every[r, :n] for r, n in enumerate(counts)])


def allgather_object(obj: Any) -> List[Any]:
    """Every process's ``obj`` (any picklable value), in process order;
    ``[obj]`` in one process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def broadcast_one_to_all(obj: Any) -> Any:
    """Process 0's ``obj`` on every process (any picklable value; tensors
    should be on the host). In one process, ``obj`` itself."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is True on any of them: a
    branch every process must take together (an interrupt, a stop)."""
    if process_count() == 1:
        return flag
    return bool(all_reduce_sum(torch.tensor([int(flag)], dtype=torch.int64)).item())


class _SumAcrossProcesses(torch.autograd.Function):
    """y = the sum of x over processes; dL/dx = the sum of dL/dy over
    processes, since every process's rows reach the loss through y."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone())


def sum_across_processes(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce_sum` with autograd (global BatchNorm sums): the
    backward sums the gradient over the processes, so each process's
    share of the statistics gets the whole batch's gradient."""
    if process_count() == 1:
        return x
    return _SumAcrossProcesses.apply(x)


class _GatherRows(torch.autograd.Function):
    """y = the global batch [total, ...] from this process's rows x at
    [start, start + len(x)); dL/dx = dL/dy's rows of this process, not
    summed: every process computes the same loss from the same y, so its
    own copy of dL/dy is already the whole gradient of its rows (a sum
    over processes would scale it by their count)."""

    @staticmethod
    def forward(ctx, x, start, total):
        ctx.rows = slice(start, start + x.shape[0])
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[ctx.rows] = x
        return all_reduce_sum(buf)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None, None


def gather_rows(x: torch.Tensor, start: int, total: int) -> torch.Tensor:
    """The global batch's rows [total, ...] on every process, from each
    process's rows ``x`` at global offset ``start``, with autograd (see
    ``_GatherRows`` for the gradient). In one process ``x`` must be the
    whole batch, and is returned as it is."""
    if process_count() == 1:
        if start != 0 or x.shape[0] != total:
            raise ValueError(f"one process holds the whole batch: rows {x.shape[0]} at "
                             f"{start}, of {total}")
        return x
    return _GatherRows.apply(x, start, total)
