"""``port_bench/work.py`` against counts worked by hand."""

import pytest

from port_bench import work
from port_bench.work import Conv, Work


def test_generator_units_small_shape():
    units = work.generator_units([[2, 4], [4, 2]], batch=1, latent_hw=(1, 1), stage=1, elem_bytes=2)
    # block 0: conv1 2->2 at 1x1 (2*9*2*2 = 72), conv2 2->4 on 2x2 phases (2*4*2*4*4 = 256);
    # bytes 2*(in 2 + out 4*4 + weights 9*2*6) + bias 4*6
    # block 1: conv1 4->4 at 2x2 (2*9*4*4*4 = 1152), conv2 4->2 on 4x4 (2*4*4*2*16 = 1024);
    # bytes 2*(16 + 2*16 + 9*4*6) + 4*6
    # head 2->2 at 4x4: 2*2*2*16 = 128 operations; bf16 in 2*2*16, float32 out 4*2*16
    assert units == [Work(328, 276), Work(2176, 552), Work(128, 192)]


def test_generator_units_synthesis_block_7():
    gen = [[32, 128], [128, 112], [112, 96], [96, 80], [80, 64], [64, 48], [48, 32], [32, 16]]
    units = work.generator_units(gen, batch=20, latent_hw=(2, 20), stage=7, elem_bytes=2)
    h, w = 2 * 128, 20 * 128
    flops = 20 * (2 * 9 * 32 * 32 * h * w + 2 * 4 * 32 * 16 * (2 * h) * (2 * w))
    assert units[7].flops == flops == 456_340_275_200
    assert units[7].bytes == 2 * (20 * 32 * h * w + 20 * 16 * 4 * h * w + 9 * 32 * 48) + 4 * 48
    assert len(units) == 9


def test_vocoder_unit():
    v = work.vocoder_unit(batch=1, n_bins=512, frames=4, n_fft=1024, hop=256)
    assert v == Work(4 * (2.5 * 1024 * 10 + 2048), 4 * (2 * 512 * 4 + 3 * 256))


def test_conv_work_and_least_time():
    c = Conv(3, 16, 32, 512 * 512, 512 * 512, 24)
    assert c.flops == 2 * 9 * 16 * 32 * 512 * 512 * 24
    assert c.work().bytes == 4 * 24 * (16 + 32) * 512 * 512 + 4 * 9 * 16 * 32
    up = Conv(3, 32, 16, 4 * 256 * 256, 256 * 256, 2, up=True)
    assert up.flops == 2 * 4 * 32 * 16 * 512 * 512 * 2
    assert up.work().bytes == 4 * 2 * (32 * 256 * 256 + 16 * 512 * 512) + 4 * 9 * 32 * 16
    w = Work(495e12, 3.35e12 / 2)
    assert w.least_s(495e12) == pytest.approx(1.0)
    assert Work(1.0, 3.35e12).least_s(495e12) == pytest.approx(1.0)
    assert work.least_s([w, Work(1.0, 3.35e12)], 495e12) == pytest.approx(2.0)


def test_critic_convs_small_shape():
    convs = work.critic_convs([[2, 4], [4, 4], [4, 8]], batch=1, size=8, disc_stage=0)
    got = [(c.k, c.cin, c.cout, c.hw, c.first) for c in convs]
    assert got == [
        (1, 2, 2, 64, True), (1, 2, 4, 16, True),        # input head, fade head on the pooled input
        (3, 2, 4, 64, False), (3, 4, 4, 16, False),      # block 0
        (3, 4, 4, 16, False), (3, 4, 4, 4, False),       # block 1
        (3, 4, 8, 4, False), (3, 8, 8, 1, False),        # block 2
        (1, 8, 1, 1, False),                             # the linear
    ]


def test_generator_train_convs_small_shape():
    convs = work.generator_train_convs([[2, 4], [4, 2]], batch=3, latent_hw=(2, 2), stage=1)
    got = [(c.k, c.cin, c.cout, c.hw, c.in_hw, c.up, c.first) for c in convs]
    assert got == [
        (3, 2, 2, 4, 4, False, True), (3, 2, 4, 16, 4, True, False),
        (3, 4, 4, 16, 16, False, False), (3, 4, 2, 64, 16, True, False),
        (1, 2, 2, 64, 64, False, False), (1, 4, 2, 16, 16, False, False),
    ]


def test_train_iteration_multiplicities():
    c, f = Conv(3, 4, 4, 16, 16, 1), Conv(1, 2, 4, 16, 16, 1, first=True)
    g, g0 = Conv(3, 4, 4, 16, 16, 1), Conv(3, 4, 4, 16, 16, 1, first=True)
    passes, wgrads = work.train_iteration_units([c, f], [g, g0], with_gen=False)
    assert len(passes) == 7 + 5 + 2 and len(wgrads) == 6
    passes, wgrads = work.train_iteration_units([c, f], [g, g0], with_gen=True)
    assert len(passes) == 14 + 2 * 2 + 2 + 1 and len(wgrads) == 6 + 2
