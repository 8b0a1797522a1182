"""Time-sharded long-clip synthesis (counterpart of
``musicgan_tpu/parallel/longclip.py``).

A long clip's latent is wide: ``(1, h, w, C)`` with ``w = 2 * nb_vec``.
Every step of synthesis is local in time except two reductions, so the clip
splits into ``mesh.size`` shards of ``w / mesh.size`` latent columns, shard
``k`` on ``mesh.devices[k]``.  JAX partitions one program and lets XLA
insert the halo exchanges and the scan carry; here each is explicit:

* **Generator.**  Every conv is 3x3 with zero padding and every up2x is
  nearest, so an output frame depends on a bounded window of latent
  columns: :func:`latent_halo` columns to each side (3 at stage 7: the 16
  conv radii through 8 floored halvings).  Shard ``k`` runs the generator
  (on a copy resident on its device) over its columns widened by that halo
  (clipped at the clip's ends, where the zero padding is the clip's own),
  then keeps its own ``256 * columns`` frames, nearest-upsampled first at a
  partial stage as ``generate._synthesize`` does.  Those frames are exact;
  the halo's are not and are dropped.
* **Magnitude.**  ``mp_to_real_imag`` divides by the clip's span (max less
  min): each shard's max and min of its own frames, then the max and min
  over the shards.  Exact: max and min do not round.
* **Phase.**  The prefix sum over time is per shard plus an exclusive
  carry, the sum of the earlier shards' totals (float32, added in shard
  order), then taken mod 2 pi.  It differs from one sum over the whole clip
  by rounding only: the sum reaches about pi x frames radians, so the two
  agree to a few float32 ulps of that.
* **Vocoder.**  An output sample in hop ``j`` reads frames ``j - 1`` to
  ``j + 2`` (``n_fft / hop = 4`` frames overlap).  Shard ``k`` takes its
  neighbours' exact frames, after their phase carry: the left one's last
  frame and the right one's first two, copied to its device, and inverts
  them with its own (K5, or the plain iSTFT, as ``resolve_istft_impl``
  decides for that length).  Inside the clip it keeps only the samples that
  every overlapping frame reaches, whose COLA envelope is the full one; at
  the clip's two ends the local trim and envelope are the clip's own.

The function returns the waveform as ``mesh.size`` pieces, each on its
shard's device, in time order (JAX's output is "sharded over the mesh");
:func:`join_pieces` joins them on the host.  Shards on one device run one
after another; on distinct cards the launches of one shard do not wait for
another's until the two reductions and the frame exchange.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..audio.functions import instantaneous_frequency, spectrum_parts, unit_magnitude
from ..audio.stft import istft_real_imag
from ..config import AudioConfig, ModelConfig
from ..models.generator import Generator
from ..models.layers import library_numerics
from ..ops.istft_fused import istft_fused
from .mesh import Mesh

__all__ = ["sharded_synthesize_fn", "join_pieces", "latent_halo", "VOCODER_HALO"]

# Spectrum frames a shard borrows from its left and right neighbours: an
# output sample in hop j reads frames j - 1 .. j + 2 (n_fft / hop = 4).
VOCODER_HALO = (1, 2)


def latent_halo(stage: int) -> int:
    """Latent columns to each side that a stage-``stage`` output frame
    depends on: back from an output column through each block (conv2's
    radius at the block's output, the nearest up2x's floor, conv1's radius
    at its input).  A shard widened by this many columns computes its own
    frames exactly."""
    cols = 2 ** (stage + 1)  # image columns a latent column becomes
    left, right = 0, cols - 1  # latent column 0's own image columns
    for _ in range(stage + 1):
        left = (left - 1) // 2 - 1
        right = (right + 1) // 2 + 1
    return max(-left, right)


def join_pieces(pieces) -> torch.Tensor:
    """The whole waveform on the host from :func:`sharded_synthesize_fn`'s
    pieces."""
    return torch.cat([p.cpu() for p in pieces])


def sharded_synthesize_fn(
    mesh: Mesh,
    model_cfg: ModelConfig = ModelConfig(),
    stage: int = 7,
    axis: str = "data",
):
    """Build ``f(gen, z) -> pieces``, synthesis sharded along time over
    ``mesh``.

    ``z``: ``(1, h, w_total, C)`` (numpy or tensor), ``w_total`` divisible
    by ``mesh.size``.  The pieces joined are the waveform of length ``(256 *
    w_total - 1) * hop`` that ``generate.synthesize_fn(model_cfg, stage)``
    gives for ``z``.  ``model_cfg.conv_impl`` "auto" resolves once a clip,
    among the float32 candidates only (JAX's clip is float32 throughout:
    its "auto" is "xla"), under the widest shard's widened latent, and
    every shard runs that impl; the vocoder resolves per shard length (both
    of its routes are float32).  ``axis`` is the mesh's axis name, as in
    JAX."""
    from ..ops.autotune import FLOAT32_IMPLS, resolve_conv_impl, resolve_istft_impl

    acfg = AudioConfig()
    hop, n = acfg.stft_stride, mesh.size
    devices = tuple(  # "cuda" is the current card, as tensors placed there land
        torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
        for d in mesh.devices
    )
    n_stages = model_cfg.n_stages
    halo = latent_halo(stage)
    px = 2 ** (stage + 1)  # image columns of a latent column at this stage
    upsample = 2 ** (n_stages - 1 - stage)  # to the full 512-bin resolution
    copies: dict = {}  # device -> (stamp of the weights, generator there)

    def generator_on(gen: Generator, dev: torch.device) -> Generator:
        """``gen`` where it lives, else a copy on ``dev``, made anew when the
        weights change (in place, which bumps their versions)."""
        if next(gen.parameters()).device == dev:
            return gen
        stamp = (id(gen), tuple((p.data_ptr(), p._version) for p in gen.parameters()))
        hit = copies.get(dev)
        if hit is None or hit[0] != stamp:
            copy = Generator(gen.cfg, device=dev)
            copy.load_state_dict(gen.state_dict())
            hit = copies[dev] = (stamp, copy.eval())
        return hit[1]

    @torch.no_grad()
    def f(gen: Generator, z) -> list[torch.Tensor]:
        z = torch.as_tensor(z, dtype=torch.float32)
        if z.ndim != 4 or z.shape[0] != 1:
            raise ValueError(f"a long clip is one latent (1, h, w, C), got {tuple(z.shape)}")
        w = z.shape[2]
        if w % n:
            raise ValueError(f"latent width {w} does not divide over {n} shards")
        cols = w // n
        spans = [(max(0, k * cols - halo), min(w, (k + 1) * cols + halo)) for k in range(n)]
        widest = max(b - a for a, b in spans)
        impl = resolve_conv_impl(
            model_cfg, (1, z.shape[1], widest, z.shape[3]), stage, device=devices[0],
            candidates=FLOAT32_IMPLS,
        ).conv_impl

        # Generator, magnitude and instantaneous frequency, shard by shard.
        magn, freq = [], []
        for k, (dev, (a, b)) in enumerate(zip(devices, spans)):
            lo, hi = k * cols, (k + 1) * cols
            zk = z[:, :, a:b].to(dev)
            img = generator_on(gen, dev).forward_nchw(zk.permute(0, 3, 1, 2), stage, 1.0, impl)
            img = img[..., (lo - a) * px : (hi - a) * px]  # this shard's own frames
            if upsample > 1:
                img = F.interpolate(img, scale_factor=upsample, mode="nearest")
            magn.append(unit_magnitude(img[0, 0]))
            freq.append(instantaneous_frequency(img[0, 1]))

        # The two reductions over the clip: the magnitude's span and the
        # phase's prefix sum (per shard, plus the earlier shards' totals).
        home = devices[0]
        top = torch.stack([m.amax().to(home) for m in magn]).amax()
        bottom = torch.stack([m.amin().to(home) for m in magn]).amin()
        span = top - bottom
        spectra, carry = [], None
        for k, dev in enumerate(devices):
            phase = torch.cumsum(freq[k], dim=-1)
            total = phase[:, -1].to(home)
            if carry is not None:
                phase = phase + carry.to(dev)[:, None]
            carry = total if carry is None else carry + total
            spectra.append(spectrum_parts(magn[k] / span.to(dev), phase))
        del magn, freq

        # Vocoder: each shard with its neighbours' exact frames.
        left, right = VOCODER_HALO
        pieces = []
        for k, dev in enumerate(devices):
            parts = [spectra[k]]
            if k > 0:
                parts.insert(0, tuple(x[:, -left:].to(dev) for x in spectra[k - 1]))
            if k < n - 1:
                parts.append(tuple(x[:, :right].to(dev) for x in spectra[k + 1]))
            real = torch.cat([p[0] for p in parts], dim=-1)
            imag = torch.cat([p[1] for p in parts], dim=-1)
            if resolve_istft_impl(real.shape[-1], device=dev) == "pallas":
                y = istft_fused(real, imag, n_fft=acfg.n_fft, hop=hop)
            else:
                with library_numerics():  # its products in float32, not TF32
                    y = istft_real_imag(real, imag, n_fft=acfg.n_fft, hop=hop)
            own = spectra[k][0].shape[-1]
            start = left * hop if k > 0 else 0
            length = (own - (1 if k == n - 1 else 0)) * hop
            pieces.append(y[start : start + length])
        return pieces

    return f
