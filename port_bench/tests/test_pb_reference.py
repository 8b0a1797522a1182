"""The plain reference against ``musicgan_tpu_torch``'s CPU path at a small
size, its roundings, and its controls failing the cells' limits."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from port_bench.reference import compare, lower, synthesis as ref_synth, training as ref_train

REPO = Path(__file__).resolve().parents[2]
CKPT = str(REPO / "saved_models/quality_r4/gen_final.pt")
SYNTH_LIMITS = json.loads((REPO / "port_bench/configs/musicgan-r4-synth.json").read_text())["limits"]
TRAIN_LIMITS = json.loads((REPO / "port_bench/configs/musicgan-train.json").read_text())["limits"]


@pytest.fixture(scope="module")
def shipped():
    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.models.torch_ingest import load_reference_generator

    gen = load_reference_generator(CKPT, ModelConfig(), device="cpu")
    z = torch.randn((2, 2, 2, 32), generator=torch.Generator().manual_seed(3))
    return gen, ref_synth.load_generator(CKPT, 8, "cpu"), z


def test_generator_image_is_the_ports(shipped):
    gen, weights, z = shipped
    with torch.no_grad():
        ours = gen.forward_nchw(z.permute(0, 3, 1, 2), 7, 1.0, "xla")
    theirs = ref_synth.generator_image(weights, z, 8)
    assert theirs.shape == ours.shape == (2, 2, 512, 512)
    # float32 rounding grows through the eight PixelNorms: both paths are
    # about 5e-4 (max) from float64 at block 7.
    assert torch.linalg.vector_norm(theirs - ours) <= 1e-4 * torch.linalg.vector_norm(ours)


def test_vocoder_is_the_ports(shipped):
    from musicgan_tpu_torch.audio import mp_to_real_imag
    from musicgan_tpu_torch.audio.stft import istft_real_imag

    _, weights, z = shipped
    img = ref_synth.generator_image(weights, z, 8)
    real, imag = mp_to_real_imag(img[:, None])
    ours = istft_real_imag(real, imag)
    theirs = ref_synth.vocode(img)
    assert theirs.shape == ours.shape == (2, 511 * 256)
    assert (theirs - ours).abs().max() <= 1e-4 * ours.abs().max()


def test_synthesis_controls_fail_the_limits(shipped):
    """The program's CPU path passes both stages; fp8 operands in the
    generator fail the image's limit, a bf16 vocoder the waveform's."""
    gen, weights, z = shipped
    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.generate import synthesize_fn

    from port_bench.drivers.synth_offline import observe_images

    box = observe_images(gen)
    waves = synthesize_fn(ModelConfig(), 7)(gen, z)
    r = ref_synth.generator_image(weights, z, 8)
    v = ref_synth.vocode(box["last"])
    assert max(compare.rel_gaps(box["last"], r)) < SYNTH_LIMITS["image_gap"]
    assert max(compare.rel_gaps(waves, v)) < SYNTH_LIMITS["wave_gap"]
    fp8 = ref_synth.generator_image(weights, z, 8, rounding=lower.operand_rounding("float8_e4m3fn"))
    assert min(compare.rel_gaps(fp8, r)) > SYNTH_LIMITS["image_gap"]
    bf16 = ref_synth.vocode(box["last"], rounding=lower.operand_rounding("bfloat16"))
    assert min(compare.rel_gaps(bf16, v)) > SYNTH_LIMITS["wave_gap"]


def test_roundings():
    one = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -3.0], dtype=torch.float32)
    assert lower.round_tf32(one).tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10, -3.0]
    x = torch.tensor([448.0, 1.0, 0.5, -224.0])
    assert torch.equal(lower.round_fp8(x), x)
    assert lower.round_fp8(torch.tensor([448.0, 1.03]))[1] == 1.0


def _tiny():
    from musicgan_tpu_torch.config import ModelConfig, TrainConfig

    mcfg = ModelConfig(rand_channels=4, gen_channels=((4, 8), (8, 8), (8, 4)),
                       disc_channels=((4, 8), (8, 8), (8, 8), (8, 8)), conv_impl="pallas_gp")
    return mcfg, TrainConfig(batch_size=4)


@pytest.mark.parametrize("impl", ["pallas_gp", "xla"])
def test_train_iteration_is_the_ports(impl):
    """One generator iteration at stage 2 from the same weights, rows and
    noise: the losses, every leaf's gradient, and the gaps the cell
    compares (the first gradient's and the change's norms) under its
    limits."""
    from musicgan_tpu_torch.train.step import build_step, init_train_state

    from port_bench.drivers import train_step as drv
    from port_bench.drivers.train_step import draw_noise, make_weights

    mcfg, tcfg = _tiny()
    mcfg = dataclasses.replace(mcfg, conv_impl=impl)
    state = init_train_state(0, mcfg, tcfg, device="cpu")
    w_g, w_d = make_weights(mcfg, 5, torch.device("cpu"))
    w0 = {"g": {k: v.clone() for k, v in w_g.items()}, "d": {k: v.clone() for k, v in w_d.items()}}
    with torch.no_grad():
        for net, w in ((state.gen, w_g), (state.disc, w_d)):
            for k, p in net.named_parameters():
                p.copy_(w[k])
    x = torch.rand((4, 2, 16, 16), generator=torch.Generator().manual_seed(1)) * 2 - 1
    noise = draw_noise(torch.Generator().manual_seed(2), mcfg, 4, torch.device("cpu"))
    state, m = build_step(2, True, mcfg, tcfg, device="cpu")(state, x, 0.5, noise=noise)

    opt_g, opt_d = ref_train.Adam(w_g, 1e-3, 0.0, 0.9), ref_train.Adam(w_d, 1e-3, 0.0, 0.9)
    out = ref_train.iteration(w_g, w_d, opt_g, opt_d, x, noise, 2, 0.5, True, 0.2, 1e-8, 10.0, rows=3)
    assert float(m["disc_loss"] + m["grad_pen"]) == pytest.approx(out["critic_loss"], rel=1e-5)
    assert float(m["gen_loss"]) == pytest.approx(out["gen_loss"], rel=1e-5, abs=1e-7)
    norms = {}
    for net, grads, opt, params in (("g", out["gen_grads"], state.opt_gen, w_g),
                                    ("d", out["disc_grads"], state.opt_disc, w_d)):
        for k, g in grads.items():
            if g is None:  # a leaf the loss does not reach has no moment either
                assert not opt.mu[k].any(), k
        module = state.gen if net == "g" else state.disc
        norms[net] = ({k: float(torch.linalg.vector_norm(v)) for k, v in opt.mu.items()},
                      {k: float(torch.linalg.vector_norm(p - w0[net][k])) for k, p in module.named_parameters()},
                      {k: None if g is None else float(torch.linalg.vector_norm(g)) for k, g in grads.items()},
                      {k: float(torch.linalg.vector_norm(params[k] - w0[net][k])) for k in params})
    prog = ([[float(m["disc_loss"] + m["grad_pen"]), float(m["gen_loss"])]],
            {n: v[0] for n, v in norms.items()}, {n: v[1] for n, v in norms.items()})
    refr = ([[out["critic_loss"], out["gen_loss"]]], {n: v[2] for n, v in norms.items()},
            {n: v[3] for n, v in norms.items()})
    gaps = drv.gaps(prog, refr)
    assert all(gaps[name] <= limit for name, limit in TRAIN_LIMITS.items()), gaps
