"""The port's ToMagnPhase head (``musicgan_tpu_torch/ops/head.py``) on the
CPU: the rule by which the generator picks the bf16 head kernel or its
plain version, the generator's use of that rule, and the plain version
against the JAX package's ``_head_nchw``.  The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from musicgan_tpu.models.generator import _head_nchw
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models import Generator
from musicgan_tpu_torch.ops import head as head_ops

# Every head width of the generator (config.py's gen_channels outputs and
# the first block's 128).
HEAD_WIDTHS = [16, 32, 48, 64, 80, 96, 112, 128]


@pytest.mark.parametrize("dtype,device_type,needs_grad,kernel", [
    (torch.bfloat16, "cuda", False, True),
    (torch.bfloat16, "cuda", True, False),
    (torch.bfloat16, "cpu", False, False),
    (torch.bfloat16, "cpu", True, False),
    (torch.float32, "cuda", False, False),
    (torch.float32, "cuda", True, False),
    (torch.float32, "cpu", False, False),
    (torch.float32, "cpu", True, False),
])
def test_route_takes_the_kernel_only_for_bf16_on_the_card_without_a_gradient(dtype, device_type, needs_grad,
                                                                             kernel):
    assert head_ops.takes_kernel(dtype, device_type, needs_grad) is kernel


def _bf16_exact(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("c", HEAD_WIDTHS)
def test_plain_head_matches_jax_on_bf16_exact_inputs(c):
    """bf16 input, float32 weights: both upcast the input exactly, so only
    float32 summation order separates them.  W = 37 is no multiple of 8."""
    rng = np.random.default_rng(c)
    x = _bf16_exact(rng, (2, c, 4, 37))
    w = (rng.uniform(-1, 1, (2, c)) / np.sqrt(c)).astype(np.float32)
    b = (rng.uniform(-1, 1, 2) / np.sqrt(c)).astype(np.float32)
    got = head_ops.head1x1_plain(x, torch.from_numpy(w), torch.from_numpy(b))
    ref = _head_nchw({"w": jnp.asarray(w.T[None, None]), "b": jnp.asarray(b)},
                     jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 4, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


def test_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    x = _bf16_exact(rng, (3, 16, 5, 12))
    w = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(2).astype(np.float32))
    n = head_ops.head1x1.launches
    assert torch.equal(head_ops.head1x1(x, w, b), head_ops.head1x1_plain(x, w, b))
    assert head_ops.head1x1.launches == n


TINY = ModelConfig(rand_channels=8, gen_channels=((8, 16), (16, 12), (12, 10), (10, 8)))


def _recorded_routes(monkeypatch):
    seen = []
    rule = head_ops.takes_kernel

    def record(dtype, device_type, needs_grad):
        seen.append((dtype, device_type, needs_grad))
        return rule(dtype, device_type, needs_grad)

    monkeypatch.setattr(head_ops, "takes_kernel", record)
    return seen


@pytest.mark.parametrize("impl,dtype", [("pallas_up_bf16", torch.bfloat16), ("pallas_up", torch.float32),
                                        ("pallas_block_bf16", torch.bfloat16)])
def test_inference_heads_ask_the_rule_with_their_dtype_and_no_gradient(monkeypatch, impl, dtype):
    """At a stage-2 fade both heads (the stage's and the previous one's)
    ask the rule, each with the blocks' dtype and no gradient wanted."""
    seen = _recorded_routes(monkeypatch)
    gen = Generator(TINY, seed=2)
    z = torch.randn(2, 8, 2, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        img = gen.forward_nchw(z, 2, 0.5, impl)
    assert img.dtype == torch.float32 and img.shape == (2, 2, 16, 32)
    assert seen == [(dtype, "cpu", False)] * 2


def test_train_forward_heads_ask_the_rule_with_a_gradient(monkeypatch):
    seen = _recorded_routes(monkeypatch)
    gen = Generator(TINY, seed=2)
    z = torch.randn(2, 8, 2, 4, generator=torch.Generator().manual_seed(0))
    gen.forward_nchw_train(z, 2, torch.tensor(0.5)).sum().backward()
    assert seen == [(torch.float32, "cpu", True)] * 2
    assert gen.heads[1].weight.grad is not None and gen.heads[2].weight.grad is not None


def test_generator_image_is_the_same_whichever_way_the_rule_goes_on_the_cpu(monkeypatch):
    """On the CPU the wrapper is the plain version, so a rule that always
    says "kernel" gives the same bits."""
    gen = Generator(TINY, seed=3)
    z = torch.randn(2, 8, 2, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = gen.forward_nchw(z, 3, 0.25, "pallas_up_bf16")
        monkeypatch.setattr(head_ops, "takes_kernel", lambda *a: True)
        got = gen.forward_nchw(z, 3, 0.25, "pallas_up_bf16")
    assert torch.equal(got, want)
