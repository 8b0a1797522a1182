"""The work of each cell counted from its shapes, and the H100's peaks.

Every roofline share and every MFU of the benchmark divides a least time,
worked out here, by a device time read from the trace.  The counts follow
the algorithm and never the kernels that run it, so that whatever a later
change does to the kernels, the numerator stays the same:

* A 3x3 "same" convolution costs ``2 * 9 * cin * cout`` operations an
  output pixel; a 1x1 one ``2 * cin * cout``.
* A 3x3 convolution of a nearest-upsampled input (the generator's second
  conv of every block) is four 2x2 convolutions of the input, one a phase
  of the output: ``2 * 4 * cin * cout`` an output pixel.  That is the least
  count of the algorithm, so a kernel that computes the phases cannot read
  above its roofline.
* Bytes: each input byte read once and each output byte written once, in
  the dtype the configuration states.  In synthesis the unit is a
  generator block (a whole-block kernel keeps the intermediate activation
  on chip): the block's input, its output and its weights.  In training the
  unit is one convolution in one role (forward, input gradient, the
  penalty's transposed convolution, weight gradient).
* A layer's least time is the sum over its units of the larger of the
  unit's operations at the dense peak and its bytes at the HBM rate.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity): bf16
989 TFLOP/s, TF32 495 TFLOP/s (a 3xTF32 product counts as one product),
HBM 3.35 TB/s.
"""

from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations and bytes of one unit of work."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def least_s(self, peak_flops: float) -> float:
        """The least time of this unit: operations at the peak or bytes at
        the HBM rate, whichever is longer."""
        return max(self.flops / peak_flops, self.bytes / HBM_BYTES_PER_S)


def least_s(units, peak_flops: float) -> float:
    """Least time of a layer: the sum of its units' least times."""
    return sum(u.least_s(peak_flops) for u in units)


def total(units) -> Work:
    return sum(units, Work())


# -- synthesis ----------------------------------------------------------------


def generator_units(gen_channels, batch: int, latent_hw, stage: int, elem_bytes: int) -> list[Work]:
    """One unit a generator block up to ``stage``, then the head.  Block
    ``i`` takes ``(batch, cin, h, w)`` with ``(h, w) = latent_hw * 2**i``:
    conv1 ``cin -> cin`` at ``(h, w)``, conv2 ``cin -> cout`` on the
    nearest-2x input.  Activations and weights in ``elem_bytes``; the head
    (1x1 ``cout -> 2`` and tanh) reads them and writes a float32 image."""
    units = []
    lh, lw = latent_hw
    for i in range(stage + 1):
        cin, cout = gen_channels[i]
        h, w = lh * 2**i, lw * 2**i
        flops = batch * (2 * 9 * cin * cin * h * w + 2 * 4 * cin * cout * 4 * h * w)
        nbytes = elem_bytes * (batch * cin * h * w + batch * cout * 4 * h * w + 9 * cin * (cin + cout))
        units.append(Work(flops, nbytes + 4 * (cin + cout)))
    cout = gen_channels[stage][1]
    hh, ww = lh * 2 ** (stage + 1), lw * 2 ** (stage + 1)
    units.append(Work(batch * 2 * cout * 2 * hh * ww, elem_bytes * batch * cout * hh * ww + 4 * batch * 2 * hh * ww))
    return units


def vocoder_unit(batch: int, n_bins: int, frames: int, n_fft: int, hop: int) -> Work:
    """Image ``(batch, 2, n_bins, frames)`` float32 in, waveform ``(batch,
    (frames - 1) * hop)`` float32 out; an inverse real FFT a frame (2.5 n
    log2 n), its window and its overlap-add."""
    flops = batch * frames * (2.5 * n_fft * math.log2(n_fft) + 2 * n_fft)
    nbytes = 4 * batch * (2 * n_bins * frames + (frames - 1) * hop)
    return Work(flops, nbytes)


# -- training -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution of a network at the cell's batch: kernel size
    ``k``, ``(cin, cout)``, output pixels ``hw`` and input pixels ``in_hw``
    (four times fewer than ``hw`` for the generator's up-convolution).
    ``first``: its input is data, so no input gradient is taken."""

    k: int
    cin: int
    cout: int
    hw: int
    in_hw: int
    batch: int
    up: bool = False
    first: bool = False

    @property
    def flops(self) -> float:
        taps = 4 if self.up else self.k * self.k
        return 2.0 * taps * self.cin * self.cout * self.hw * self.batch

    @property
    def weight_bytes(self) -> float:
        return 4.0 * self.k * self.k * self.cin * self.cout

    def work(self) -> Work:
        """One role of the convolution.  A forward, an input gradient or a
        transposed convolution reads one activation and the weights and
        writes the other activation; the weight gradient reads both
        activations and writes the weights: the same bytes."""
        return Work(self.flops, 4.0 * self.batch * (self.cin * self.in_hw + self.cout * self.hw) + self.weight_bytes)


def critic_convs(disc_channels, batch: int, size: int, disc_stage: int) -> list[Conv]:
    """The critic at ``disc_stage`` on ``size``-square inputs: its input
    head (and the fade head on the pooled input while ``disc_stage < n -
    2``), each block's two 3x3 convs (conv2 after the 2x average pool), the
    final linear."""
    n = len(disc_channels)
    convs = [Conv(1, 2, disc_channels[disc_stage][0], size * size, size * size, batch, first=True)]
    if disc_stage < n - 2:
        r = size // 2
        convs.append(Conv(1, 2, disc_channels[disc_stage + 1][0], r * r, r * r, batch, first=True))
    r = size
    for i in range(disc_stage, n):
        cin, cout = disc_channels[i]
        convs.append(Conv(3, cin, cout, r * r, r * r, batch))
        r //= 2
        convs.append(Conv(3, cout, cout, r * r, r * r, batch))
    convs.append(Conv(1, disc_channels[-1][1], 1, 1, 1, batch))
    return convs


def generator_train_convs(gen_channels, batch: int, latent_hw, stage: int) -> list[Conv]:
    """The generator's training forward up to ``stage``: each block's conv1
    and its up-convolution, the head and (past stage 0) the fade head."""
    lh, lw = latent_hw
    convs = []
    for i in range(stage + 1):
        cin, cout = gen_channels[i]
        hw = lh * lw * 4**i
        convs.append(Conv(3, cin, cin, hw, hw, batch, first=i == 0))
        convs.append(Conv(3, cin, cout, 4 * hw, hw, batch, up=True))
    out_hw = lh * lw * 4 ** (stage + 1)
    convs.append(Conv(1, gen_channels[stage][1], 2, out_hw, out_hw, batch))
    if stage > 0:
        prev_hw = out_hw // 4
        convs.append(Conv(1, gen_channels[stage - 1][1], 2, prev_hw, prev_hw, batch))
    return convs


def train_iteration_units(critic, gen, with_gen: bool) -> tuple[list[Work], list[Work]]:
    """``(passes, wgrads)``: the convolutions' forward-like passes and
    their weight gradients in one WGAN-GP iteration.

    Every iteration: the generator's forward without gradient; the critic
    on the real and the fake batch (forward, input gradient except at a
    data input), the penalty's critic forward, its explicit backward (a
    transposed convolution a layer) and that backward's own input
    gradient; weight gradients from the real and fake passes and from the
    transposed convolutions.  A generator iteration adds the generator's
    forward with gradient, the updated critic's forward and input gradient
    on its output, the generator's input gradients (not at the latent) and
    weight gradients."""
    passes, wgrads = [], []
    for c in critic:
        passes += [c.work()] * (5 if c.first else 7)
        wgrads += [c.work()] * 3
    for g in gen:
        passes.append(g.work())
    if with_gen:
        for c in critic:
            passes += [c.work()] * 2
        for g in gen:
            passes += [g.work()] * (1 if g.first else 2)
            wgrads.append(g.work())
    return passes, wgrads
