"""Shared helpers for the kernel layer: padding, the segment scatter, and the
device / backend policy every entry point and kernel wrapper follows."""
from __future__ import annotations

import torch

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
