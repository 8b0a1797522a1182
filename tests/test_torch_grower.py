"""The port's growth schedule against the JAX package's, exactly, over
seeded schedules."""

import numpy as np
import pytest

from musicgan_tpu.train.grower import Grower as JaxGrower
from musicgan_tpu_torch.train.grower import Grower


def _schedule(seed):
    rng = np.random.default_rng(seed)
    fade = (1, *(int(v) for v in rng.integers(1, 60, 7)))
    train = tuple(int(v) for v in rng.integers(5, 80, 7))
    return fade, train


def _observe(g):
    return (
        g.curr_grow, g.sample_idx, g.step_sample_idx, g.alpha, g.downscale, g.image_size,
        g.samples_to_next_stage(), tuple(g.alphas_for_next(5, 6)), g.state_dict(),
    )


@pytest.mark.parametrize("max_stage", [None, 0, 3, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grower_matches_jax(seed, max_stage):
    fade, train = _schedule(seed)
    a = Grower(fadein_lengths=fade, train_lengths=train, max_stage=max_stage)
    b = JaxGrower(fadein_lengths=fade, train_lengths=train, max_stage=max_stage)
    rng = np.random.default_rng(seed + 100)
    assert _observe(a) == _observe(b)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        assert a.grow(n) == b.grow(n)
        assert _observe(a) == _observe(b)
    cap = 7 if max_stage is None else max_stage
    assert a.curr_grow == cap


@pytest.mark.parametrize("seed", [3, 4])
def test_grower_state_dict_round_trip(seed):
    fade, train = _schedule(seed)
    a = Grower(fadein_lengths=fade, train_lengths=train)
    for _ in range(17):
        a.grow(6)
    b = Grower(fadein_lengths=fade, train_lengths=train)
    b.load_state_dict(a.state_dict())
    c = JaxGrower(fadein_lengths=fade, train_lengths=train)
    c.load_state_dict(a.state_dict())
    for _ in range(40):
        assert _observe(a) == _observe(b) == _observe(c)
        assert a.grow(6) == b.grow(6) == c.grow(6)


def test_grower_alphas_for_next_is_the_sequence_of_alpha():
    a = Grower(fadein_lengths=(1, 50, 50, 50, 50, 50, 50, 50), train_lengths=(30,) * 7)
    for _ in range(6):
        a.grow(6)
    assert a.curr_grow == 1
    want = a.alphas_for_next(4, 6)
    got = []
    for _ in range(4):
        got.append(a.alpha)
        a.grow(6)
    assert got == want


def test_grower_defaults_are_the_reference_schedule():
    a, b = Grower(), JaxGrower()
    assert (a.n_grow, tuple(a.fadein_lengths), tuple(a.train_lengths)) == (
        b.n_grow, tuple(b.fadein_lengths), tuple(b.train_lengths))
    with pytest.raises(AssertionError):
        Grower(fadein_lengths=(1, 2), train_lengths=(3,))
