"""The work of a GANSynth synthesis call, counted from its shapes.

``work.py``'s rules and peaks hold (least operations, each byte read or
written once, a unit's least time the larger of its operations at the peak
and its bytes at the HBM rate).  A note:

* the dense input: ``2 (C + n_classes) c0 h w`` operations, its float32
  weights read once;
* the six blocks and the head: ``work.generator_units`` at the latent ``(h,
  w)`` = the dense input's size (each block's second conv as four 2x2 phase
  convs on its input);
* the tail: one 3x3 conv at the last width and the image's size, its input
  read and its output written in the blocks' dtype;
* the mel products: two ``(T, n_mel) @ (n_mel, n_freq)`` products a note,
  each reading its float32 operand and the matrix and writing its float32
  result; their peak is 3xTF32's (``PEAK_FLOPS["float32"]``), which any
  float32-accurate route is at most;
* the iSTFT (K5): ``work.vocoder_unit`` on the ``n_fft / 2 + 1`` bins it
  reads, at ``n_fft`` and hop.

Published widths: 18.33 GFLOP a note in the generator (dense input, blocks,
tail, head), 0.537 in the mel products, 0.0077 in the iSTFT.
"""

from __future__ import annotations

from .work import ELEM_BYTES, PEAK_FLOPS, Work, generator_units, least_s, total, vocoder_unit

__all__ = ["dense_unit", "tail_unit", "mel_unit", "istft_unit", "generator_call_units", "call_work"]


def dense_unit(batch: int, n_in: int, c0: int, start) -> Work:
    """``(batch, n_in)`` float32 in, ``(batch, c0, h, w)`` float32 out."""
    hw = start[0] * start[1]
    return Work(2.0 * batch * n_in * c0 * hw, 4.0 * (batch * n_in + n_in * c0 * hw + c0 + batch * c0 * hw))


def tail_unit(batch: int, c: int, size, elem_bytes: int) -> Work:
    px = batch * size[0] * size[1]
    return Work(2.0 * 9 * c * c * px, elem_bytes * (2 * px * c + 9 * c * c) + 4.0 * c)


def mel_unit(batch: int, frames: int, n_mel: int, n_freq: int) -> Work:
    """The two products of a call of ``batch`` notes."""
    return Work(2 * 2.0 * batch * frames * n_mel * n_freq,
                2 * 4.0 * (batch * frames * n_mel + n_mel * n_freq + batch * frames * n_freq))


def istft_unit(batch: int, frames: int, n_fft: int, hop: int) -> Work:
    return vocoder_unit(batch, n_fft // 2 + 1, frames, n_fft, hop)


def generator_call_units(mcfg, batch: int, elem_bytes: int) -> list[Work]:
    """The dense input, each block, the head and the tail of one call."""
    stage = mcfg.n_stages - 1
    last = mcfg.gen_channels[-1][1]
    units = [dense_unit(batch, mcfg.rand_channels + mcfg.n_classes, mcfg.gen_channels[0][0], mcfg.dense_start)]
    units += generator_units(mcfg.gen_channels, batch, tuple(mcfg.dense_start), stage, elem_bytes)
    return units + [tail_unit(batch, last, mcfg.image_size((1, 1)), elem_bytes)]


def call_work(mcfg, batch: int, precision: str) -> dict:
    """Least times and operations of one call of ``batch`` notes."""
    acfg = mcfg.audio_config
    frames, n = mcfg.frames((1, 1)), acfg.n_fft // 2
    gen = generator_call_units(mcfg, batch, ELEM_BYTES[precision])
    mel, istft = mel_unit(batch, frames, n, n), istft_unit(batch, frames, acfg.n_fft, acfg.stft_stride)
    peak = PEAK_FLOPS[precision]
    return {"generator_least_s": least_s(gen, peak), "mel_least_s": mel.least_s(PEAK_FLOPS["float32"]),
            "istft_least_s": istft.least_s(PEAK_FLOPS["float32"]),
            "generator_flops": total(gen).flops, "flops": total(gen).flops + mel.flops + istft.flops,
            "peak_flops": peak}
