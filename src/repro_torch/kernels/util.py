"""Shared helpers for the kernel layer: padding, the segment scatter, and the
device / backend policy every entry point and kernel wrapper follows."""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

BACKENDS = ("cuda", "torch")


def pad_to(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m`` (at least ``m``)."""
    return max(((n + m - 1) // m) * m, m)


def pad_rows(a: torch.Tensor, n_pad: int, fill) -> torch.Tensor:
    """Pad the leading axis of ``a`` to ``n_pad`` rows with ``fill``."""
    n = a.shape[0]
    if n_pad == n:
        return a
    tail = torch.full((n_pad - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, tail], dim=0)


def segment_scatter(
    seg_ids: torch.Tensor, values: torch.Tensor, n: int, width: int
) -> torch.Tensor:
    """Fixed-width per-segment buffers from flat ``(segment, value)`` pairs.

    Pairs with either side negative are dropped; segment ``s`` keeps the
    first ``width`` surviving values in scan (flat-index) order: the stable
    segment sort breaks ties by position, so the ``searchsorted`` rank equals
    the scan rank.  Rows past ``width`` are dropped, not written.  Returns
    ``(n, width)`` int32, ``-1``-padded.
    """
    valid = (seg_ids >= 0) & (values >= 0)
    seg = torch.where(valid, seg_ids, n).to(torch.int64)
    seg_s, order = torch.sort(seg, stable=True)
    val_s = values[order]
    first = torch.searchsorted(seg_s, seg_s, side="left")
    rank = torch.arange(seg_s.shape[0], device=seg.device) - first
    ok = (seg_s < n) & (rank < width)
    out = torch.full((n, width), -1, dtype=torch.int32, device=seg.device)
    out[seg_s[ok], rank[ok]] = val_s[ok].to(torch.int32)
    return out


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Without a card, only an explicit ``device="cpu"`` runs; the port never
    carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def resolve_backend(backend: str | None, t: torch.Tensor) -> str:
    """Kernel backend for a call on tensor ``t``.

    ``None`` picks the hand-written kernel for a CUDA tensor and the plain
    version for a CPU tensor; ``"cuda"`` on a CPU tensor raises; ``"torch"``
    asks for the plain version on any device."""
    if backend is None:
        return "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r} (choices {BACKENDS})")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return backend


def no_tf32() -> None:
    """Keep the library's float32 products in full float32: TF32 keeps about
    three decimal digits, which would move distances off the reference's.

    The ``pairwise_sq_dist`` kernel does issue TF32 instructions, as 3×TF32
    (a TF32 part and a TF32 remainder of each operand, three products
    summed in f32), which keeps fp32's accuracy; it is held to a stated
    bound against its plain version (``kernels/l2dist.py``).  No kernel
    uses a single TF32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# The cost meters a caller has entered (``launch/hlo_analysis.py``'s step
# tally), the innermost last.
METERS: list = []


def metered(name: str, cost):
    """Decorate a kernel entry of ``kernels/ops.py`` for the cost meters.

    Without a meter the entry runs as it is.  Under one, a call charges the
    kernel's own work, ``cost(out, *args, **kw) -> (product flops, other
    operations, bytes)``, to the innermost meter (a fourth item, where
    given, names the kernel the call launched), and the ops the call runs
    inside (the plain version's, or the wrapper's around a launch) are not
    counted again: so a step counts the same on the CPU as on the card,
    where the kernel launches outside PyTorch's dispatcher.
    ``backend="legacy"`` launches no kernel: its ops are counted as they
    run."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kw):
            if not METERS or kw.get("backend") == "legacy":
                return fn(*args, **kw)
            return METERS[-1].kernel_call(name, cost, fn, args, kw)
        return entry
    return wrap


class OutputShapes(TorchDispatchMode):
    """Records ``(shape, dtype, bytes)`` of every tensor an op returns: the
    memory profiles' recorder."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.append((tuple(t.shape), t.dtype, t.numel() * t.element_size()))
        return out

    def peak_bytes(self) -> int:
        """The largest tensor recorded."""
        return max(nbytes for _, _, nbytes in self.seen)
