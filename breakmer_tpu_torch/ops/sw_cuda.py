"""Wrapper of the hand-written CUDA Smith-Waterman kernel
(``csrc/sw_wavefront.cu``), the port of
``breakmer_tpu/ops/sw_pallas.py::sw_score_pallas``.

The kernel library is built and loaded on the first call, never at
import, so this module imports on a machine without ``nvcc`` or a card.
The kernel runs on PyTorch's current stream and allocates nothing: the
wrapper allocates the outputs and, for a query too long for shared
memory, the global scratch for the DP state.
"""

from __future__ import annotations

from typing import Tuple

import torch

from breakmer_tpu_torch.ops.sw import SWParams

# kernel launches made by sw_score_cuda (one per call with B > 0)
LAUNCHES = 0

_MAX_THREADS = 256
_STATIC_SMEM = 1024  # the kernel's static shared memory, rounded up


def _threads(Lq: int, Lt: int) -> int:
    """Threads a block: a diagonal holds at most min(Lq, Lt) cells."""
    return min(_MAX_THREADS, max(32, -(-min(Lq, Lt) // 32) * 32))


def sw_score_cuda(
    q: torch.Tensor, t: torch.Tensor, params: SWParams = SWParams(),
    no_n: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as ``ops.sw.sw_score`` for CUDA tensors: q [B, Lq]
    and t [B, Lt] int8 on one card; returns (score, q_end, t_end), each
    [B] int32 on that card. Raises on anything the kernel does not take
    and on a launch the CUDA runtime refuses.

    no_n: caller asserts no mid-sequence N in either input; takes the
    compare-and-select substitution (bit-identical results). Ignored
    unless mismatch > 0 and gap_extend > 0, which the exactness argument
    needs (as in the TPU kernel)."""
    global LAUNCHES
    from breakmer_tpu_torch import _build

    if q.device.type != "cuda" or t.device != q.device:
        raise ValueError(f"sw_score_cuda: q on {q.device}, t on {t.device}; "
                         "both must be on one CUDA device")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError(f"sw_score_cuda: int8 codes required, got {q.dtype}, {t.dtype}")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"sw_score_cuda: shapes {tuple(q.shape)}, {tuple(t.shape)}")
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lq < 1 or Lt < 1:
        raise ValueError(f"sw_score_cuda: empty sequences (Lq={Lq}, Lt={Lt})")
    if params.match * min(Lq, Lt) >= (1 << 28) or Lq + Lt >= (1 << 30):
        raise ValueError("score range exceeds int32")
    no_n = bool(no_n) and params.mismatch > 0 and params.gap_extend > 0
    q = q.contiguous()
    t = t.contiguous()
    score = torch.empty(B, dtype=torch.int32, device=q.device)
    q_end = torch.empty_like(score)
    t_end = torch.empty_like(score)
    if B == 0:
        return score, q_end, t_end

    lib = _build.library()
    optin = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    scratch = None
    if lib.sw_wavefront_smem_bytes(Lq, 0) + _STATIC_SMEM > optin:
        scratch = torch.empty(B * 6 * Lq, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.sw_wavefront_launch(
            q.data_ptr(), t.data_ptr(), B, Lq, Lt,
            params.match, params.mismatch, params.gap_open, params.gap_extend,
            int(no_n), _threads(Lq, Lt),
            scratch.data_ptr() if scratch is not None else None,
            score.data_ptr(), q_end.data_ptr(), t_end.data_ptr(), _build.stream_of(q),
        )
    _build.check_launch(err, f"sw_wavefront (B={B}, Lq={Lq}, Lt={Lt})")
    LAUNCHES += 1
    return score, q_end, t_end
