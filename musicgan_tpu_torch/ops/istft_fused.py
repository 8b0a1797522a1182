"""Fused inverse STFT: a hand-written CUDA kernel for Hopper beside its
plain PyTorch version.

``istft_fused`` (K5) replaces ``musicgan_tpu/ops/istft_pallas.py::
istft_fused`` (Pallas kernel from ``_kernel_factory``); the kernel is
``csrc/istft.cu``.  The Hann window and the ``normalized=True`` scale are
folded into the iDFT bases ahead of time (``_windowed_idft_bases``:
``(A @ B) * w == A @ (B * w)`` since the window scales output columns),
and the overlap-add is the sum over ``r = n_fft / hop`` row-shifted
products, so the ``(T, n_fft)`` frame matrix never reaches device memory.

What bounds it on an H100: float32 operations.  Each output sample costs
``2 * 2 * r * n_bins`` FLOP (8,208 at n_fft 1024) against a few bytes of
spectrum, far above the card's float32 ridge of about 20 FLOP/byte.  The
design is a register-tiled product: a block owns a 64 x 128 piece of the
signal, a thread 8 x 4 of it, fed by float4 loads from shared memory that
``cp.async`` fills.  Full float32 (the TPU saw 3.6e-4 error at its default
bf16 matmul precision); tensor cores in TF32 would break the 2e-4 bar.

The COLA division and the centring trim stay plain PyTorch
(``audio/stft.py::cola_trim``), as they stay XLA in JAX.

Dispatch: a CPU tensor takes the plain version, the port's vocoder
``audio/stft.py::istft_real_imag``; a CUDA tensor launches the kernel;
anything else raises.  ``istft_fused.launches`` counts launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from ..audio.stft import _idft_bases, cola_trim, hann_window, istft_real_imag

__all__ = ["istft_fused"]


@functools.lru_cache(maxsize=8)
def _windowed_idft_bases(
    n_fft: int, normalized: bool, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """iDFT bases ``(n_bins, n_fft)`` with the synthesis window (and the
    ``normalized=True`` rescale of ``istft_real_imag``) folded into the
    output columns, computed in float64 and kept on ``device``."""
    cos_ib, sin_ib = _idft_bases(n_fft)
    w = hann_window(n_fft, np.float64)
    scale = np.sqrt(np.sum(w**2)) if normalized else 1.0
    return tuple(
        torch.from_numpy((b.astype(np.float64) * w[None, :] * scale).astype(np.float32)).to(device)
        for b in (cos_ib, sin_ib)
    )


_ISTFT_ARGS = [_build.PTR] * 5 + [_build.INT] * 5


def istft_fused(real, imag, n_fft: int = 1024, hop: int = 256, normalized: bool = True):
    """Inverse STFT from ``(B, n_bins, T)`` (or unbatched ``(n_bins, T)``)
    real/imag parts -> ``(B, (T-1)*hop)`` signals; the same function as
    ``audio.stft.istft_real_imag``, its plain version."""
    assert n_fft % hop == 0
    if real.device.type == "cpu":
        return istft_real_imag(real, imag, n_fft, hop, normalized)
    if real.device.type != "cuda":
        raise ValueError(f"istft_fused: no kernel for device {real.device}")
    unbatched = real.ndim == 2
    if unbatched:
        real, imag = real[None], imag[None]
    _, n_bins, t = real.shape
    assert n_fft // 2 + 1 == n_bins, (n_bins, n_fft)
    wcos, wsin = _windowed_idft_bases(n_fft, normalized, real.device)
    y = cola_trim(_launch(real, imag, wcos, wsin, n_fft, hop), t, n_fft, hop)
    istft_fused.launches += 1
    return y[0] if unbatched else y


def _launch(real, imag, wcos, wsin, n_fft, hop):
    bsz, n_bins, t = real.shape
    for x in (real, imag):
        if x.device != real.device or x.dtype != torch.float32:
            raise ValueError(f"istft_fused: spectra must be float32 on {real.device}")
    real, imag = real.contiguous(), imag.contiguous()
    r = n_fft // hop
    out = torch.empty(bsz, (t + r - 1) * hop, device=real.device, dtype=torch.float32)
    _build.kernel("istft", "mg_istft_ola", _ISTFT_ARGS)(
        real.data_ptr(), imag.data_ptr(), wcos.data_ptr(), wsin.data_ptr(),
        out.data_ptr(), bsz, n_bins, t, hop, r, device=real.device,
    )
    return out


istft_fused.launches = 0
