"""The port's whole-block op (K4) and the generator's ``conv_impl ==
"pallas_block"`` forward against the JAX package, on the CPU: the port runs
``fused_block``'s plain version, JAX runs its Pallas kernel in interpret
mode, both on inputs made with numpy from a seed."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.models.generator import generator_forward, init_generator
from musicgan_tpu.ops.conv import fused_block as jax_fused_block
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models import Generator, params_from_jax
from musicgan_tpu_torch.ops import conv as conv_ops
from tests.tiny_cfg import TINY_MODEL

CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
    conv_impl="pallas_block",
)


def _block_inputs(seed, b, cin, cmid, cout, h, w):
    """HWIO weights as the JAX package keeps them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (
        f32(rng.standard_normal((b, cin, h, w))),
        f32(rng.standard_normal((3, 3, cin, cmid)) * 0.1), f32(rng.standard_normal(cmid) * 0.1),
        f32(rng.standard_normal((3, 3, cmid, cout)) * 0.1), f32(rng.standard_normal(cout) * 0.1),
    )


def _oihw(w_hwio):
    """HWIO -> OIHW, the transposition ``params_from_jax`` applies."""
    sd = params_from_jax({"blocks": [{"conv1": {"w": w_hwio, "b": np.zeros(w_hwio.shape[3], np.float32)},
                                      "conv2": {"w": w_hwio, "b": np.zeros(w_hwio.shape[3], np.float32)}}],
                          "heads": []})
    return sd["blocks.0.conv1.weight"]


# The two shapes of tests/test_ops.py::test_fused_block_parity (cmid differs
# from cin in the first) and one whose height and width divide no tile.
@pytest.mark.parametrize("b,cin,cmid,cout,h,w",
                         [(1, 16, 24, 32, 8, 256), (2, 8, 8, 8, 4, 128), (1, 5, 7, 3, 13, 37)])
def test_fused_block_matches_jax_interpret(b, cin, cmid, cout, h, w):
    """atol 1e-4: two float32 convs of up to 216 products each, summed in
    another order, on outputs of order 1 after PixelNorm."""
    x, w1, b1, w2, b2 = _block_inputs(b + h, b, cin, cmid, cout, h, w)
    ref = np.asarray(jax_fused_block(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                     slope=0.2, eps=1e-8, interpret=True))
    n0 = conv_ops.fused_block.launches
    got = conv_ops.fused_block(
        torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2), 0.2, 1e-8)
    assert conv_ops.fused_block.launches == n0  # a CPU tensor takes the plain version
    assert got.shape == (b, cout, 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


# Past 128 channels the card splits each conv over a cluster of blocks.
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", [(1, 8, 144, 136, 5, 9), (1, 4, 136, 24, 3, 6)])
def test_fused_block_past_128_channels_matches_jax_interpret(b, cin, cmid, cout, h, w):
    """atol 2e-5: the first conv sums 72 products, the second 4 x 144."""
    x, w1, b1, w2, b2 = _block_inputs(cmid + cout, b, cin, cmid, cout, h, w)
    ref = np.asarray(jax_fused_block(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                     slope=0.2, eps=1e-8, interpret=True))
    got = conv_ops.fused_block(
        torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2), 0.2, 1e-8)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_fused_block_plain_is_the_pair_and_takes_packed_weights():
    x, w1, b1, w2, b2 = _block_inputs(3, 2, 6, 10, 4, 5, 9)
    xt, b1t, b2t = (torch.from_numpy(a) for a in (x, b1, b2))
    w1t, w2t = _oihw(w1), _oihw(w2)
    pair = conv_ops.upconv3x3_plain(
        conv_ops.conv3x3_plain(xt, w1t, b1t, 0.2, True, 1e-8), w2t, b2t, 0.2, True, 1e-8)
    got = conv_ops.fused_block(
        xt, w1t, b1t, w2t, b2t, 0.2, 1e-8,
        w1_packed=conv_ops.kernel_weights(w1t), w2_packed=conv_ops.kernel_upconv_weights(w2t))
    assert torch.equal(got, pair)
    assert torch.equal(conv_ops.fused_block_plain(xt, w1t, b1t, w2t, b2t, 0.2, 1e-8), pair)


def test_fused_block_device_rule():
    """CPU -> plain version, CUDA -> the kernel, anything else raises."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _block_inputs(0, 1, 4, 4, 4, 2, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        conv_ops.fused_block(x.to("meta"), w1, b1, w2, b2)


def test_fused_block_fits_is_the_cards_rule():
    """True for blocks 4 to 7 of the full-width generator at the main
    path's sizes (5 clips, nb_vec 10) on an H100, blocks 6 and 7 being the
    two JAX runs through its block kernel in float32: there K1 and K3 both
    take the tensor-core route and runs of 8 rows of K4's 62-column strips
    fill half the card.  By the widths alone K4 takes every block: its geometry
    (the conv template's tiles, a ring of c1 rows, a cluster past 128
    channels) fits a thread block's shared memory at every width up to
    1,024."""
    chans = ModelConfig().gen_channels
    sizes = [(5, 2 * 2**i, 20 * 2**i) for i in range(len(chans))]
    fits = [conv_ops.fused_block_fits(cin, cin, cout, size=s) for (cin, cout), s in zip(chans, sizes)]
    assert fits[6] and fits[7]
    assert fits == [False, False, False, False, True, True, True, True]
    assert all(conv_ops.fused_block_fits(cin, cin, cout) for cin, cout in chans)
    # A short call (2 clips, nb_vec 2) leaves blocks 4 and 5 to the pair:
    # their strips would not fill half the card.
    small = [conv_ops.fused_block_fits(cin, cin, cout, size=(2, 2 * 2**i, 4 * 2**i))
             for i, (cin, cout) in enumerate(chans)]
    assert small == [False] * 6 + [True, True]
    for cmid, cout in [(1, 1), (16, 128), (32, 16), (48, 32), (64, 48), (65, 16), (128, 128), (32, 128),
                       (136, 144), (1024, 16), (16, 1024)]:
        tile = conv_ops.block_tile(cmid, cout)
        assert tile["smem_bytes"] <= conv_ops.SMEM_OPTIN_BYTES and 2 <= tile["stages"] <= 4
        assert tile["cluster"] == max(-(-cmid // 128), -(-cout // 128)) <= 8
        assert tile["n1"] * tile["nsplit1"] >= cmid and tile["n2"] * tile["nsplit2"] >= cout
        assert tile["ring_rows"] >= tile["th2"] + 2
        assert conv_ops.fused_block_fits(3, cmid, cout)
    # The three blocks of the path hold each conv's channels as K1 and K3 do.
    for cmid, cout in [(64, 48), (48, 32), (32, 16)]:
        tile = conv_ops.block_tile(cmid, cout)
        assert (tile["n1"], tile["n2"], tile["cluster"]) == (cmid, cout, 1)
    assert conv_ops.block_tile(1025, 16) is None and conv_ops.block_tile(16, 1025) is None
    assert not conv_ops.fused_block_fits(16, 1025, 16)


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_generator_pallas_block_matches_jax(alpha):
    """``TINY_MODEL`` at stage 3 against JAX's same impl (Pallas in interpret
    mode), 2e-5 as the other impls are held; past stage 3 JAX's own lowerings
    disagree with each other by more than that."""
    jcfg = dataclasses.replace(TINY_MODEL, conv_impl="pallas_block")
    params = jax.tree_util.tree_map(np.asarray, init_generator(jax.random.PRNGKey(5), TINY_MODEL))
    z = np.random.default_rng(11).standard_normal((2, 2, 4, TINY_MODEL.rand_channels)).astype(np.float32)
    ref = np.asarray(generator_forward(params, jnp.asarray(z), 3, alpha, jcfg))
    gen = Generator(CFG)
    gen.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = gen(torch.from_numpy(z), 3, alpha).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_generator_takes_the_block_kernel_only_where_it_fits(monkeypatch):
    calls = {"block": [], "conv": [], "up": []}
    for key, name in (("block", "fused_block"), ("conv", "fused_conv3x3"), ("up", "fused_upconv3x3")):
        real = getattr(conv_ops, name)
        monkeypatch.setattr(
            conv_ops, name,
            lambda x, *a, _real=real, _key=key, **kw: (calls[_key].append(x.shape[1]), _real(x, *a, **kw))[1],
        )
    # At 8 clips of a 2 x 66 latent only block 3 (16 x 528) is large
    # enough for K4's size rule on an H100; block 2 (8 x 264) has too few
    # strips to fill the card.
    wide = ModelConfig(
        rand_channels=8, conv_impl="pallas_block",
        gen_channels=((8, 80), (80, 70), (70, 16), (16, 4)),
    )
    z = torch.randn(8, 8, 2, 66, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y_block = Generator(wide, seed=3).forward_nchw(z, 3)
        assert calls == {"block": [16], "conv": [8, 80, 70], "up": [8, 80, 70]}
        for v in calls.values():
            v.clear()
        y_pair = Generator(dataclasses.replace(wide, conv_impl="pallas_up"), seed=3).forward_nchw(z, 3)
    assert calls == {"block": [], "conv": [8, 80, 70, 16], "up": [8, 80, 70, 16]}
    assert torch.equal(y_block, y_pair)  # on the CPU both are the same plain versions


@pytest.mark.parametrize("name,error", [
    ("xla", None), ("auto", None), ("pallas", None),
    ("pallas_block_bf16", None), ("pallas_up_bf16", None), ("pallas_bf16", None),
    ("pallas_train", None), ("no_such_impl", ValueError),
])
def test_conv_impl_names(name, error):
    """Every name of the JAX package's ``conv_impl`` is ported, "auto" the
    default as there; any other name raises."""
    if error is None:
        assert ModelConfig(conv_impl=name).conv_impl == name
    else:
        with pytest.raises(error, match="unknown"):
            ModelConfig(conv_impl=name)
    assert ModelConfig().conv_impl == "auto"
    assert ModelConfig(conv_impl="pallas_block").conv_impl == "pallas_block"
