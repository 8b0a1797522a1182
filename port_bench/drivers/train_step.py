"""The WGAN-GP train step at a grown stage, iteration after iteration.

The program's step is ``build_step(stage, with_gen, model_cfg, train_cfg,
device_data=True)``, as ``train()`` builds it for a device-resident corpus:
``step(state, corpus, idx, alpha, noise)``.  The benchmark makes everything
the step is handed from the seed, on the card: the initial weights (one
normal draw at He's scale, zero biases: :func:`make_weights`), the corpus,
the index batches (one permutation of the corpus an epoch), and each
iteration's noise.  Iteration ``i`` trains the generator where ``i %
n_critic == 0``.

Set-up builds one train state and drives it through its first
``first_steps`` iterations (a generator iteration, then critic-only ones)
through the window's own call and feed; the window continues the same
state.  Before the window the set-up keeps, as device scalars, each of
those steps' losses, each leaf's norm of the first gradient (Adam's first
moment after step 1 over ``1 - b1``) and, after the last of them, each
leaf's norm of its change from the initial weights.  The host waits on the
iteration before last, so one is always queued; the window closes at the
first completion past ``--seconds`` that ends a whole n_critic cycle, and
the rate is the samples of the iterations completed over the whole window.

``correct``: the reference (``reference/training.py``) runs the same first
steps from the same weights, rows and noise; the numbers of :func:`gaps`
that the configuration's ``limits`` name are compared: the first step's
loss, the first gradient by its worst leaf and the critic's median leaf,
and the change by its median leaf (``reference/compare.py``).
"""

from __future__ import annotations

import statistics
import time
from collections import deque

import torch

from ..reference import compare, training as ref
from ..reference.lower import numerics
from ..work import PEAK_FLOPS, critic_convs, generator_train_convs, least_s, total, train_iteration_units
from .common import Completion, device_generator, free_device, model_config


def train_config(config: dict):
    from musicgan_tpu_torch.config import TrainConfig

    t = dict(config.get("train", {}))
    t["betas"] = tuple(t.get("betas", (0.0, 0.9)))
    return TrainConfig(**t, batch_size=int(config["batch_size"]))


def make_weights(mcfg, seed: int, device) -> tuple[dict, dict]:
    """The initial weights, from the seed, on ``device``: one normal draw
    for every weight, each leaf scaled to ``gain / sqrt(fan_in)``, and zero
    biases.  The gain is He's ``sqrt(2 / (1 + slope**2))`` before a
    LeakyReLU and 1 where none follows (the generator's tanh heads, the
    critic's linear), as the ProGAN family draws them.  At PyTorch's default
    ``U(+-1/sqrt(fan_in))`` the 18 convolutions of the stage-7 critic shrink
    its activations by some 1e-7 and its output no longer depends on its
    input; at this scale it does."""
    shapes_g, shapes_d = ref.param_shapes(mcfg.gen_channels, mcfg.disc_channels, mcfg.rand_channels)
    shapes = [("g", k, s) for k, s in shapes_g.items()] + [("d", k, s) for k, s in shapes_d.items()]
    weights = [(net, k, s) for net, k, s in shapes if k.endswith(".weight")]
    sizes = [int(torch.Size(s).numel()) for _, _, s in weights]
    g = device_generator(seed, 10, device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    he = (2.0 / (1.0 + mcfg.leaky_slope**2)) ** 0.5
    out = {"g": {}, "d": {}}
    for (net, k, s), piece in zip(weights, torch.split(flat, sizes)):
        gain = 1.0 if k == "clf.weight" or (net == "g" and k.startswith("heads.")) else he
        out[net][k] = (piece * (gain / int(torch.Size(s[1:]).numel()) ** 0.5)).reshape(s).clone()
    for net, k, s in shapes:
        if not k.endswith(".weight"):
            out[net][k] = torch.zeros(s, device=device)
    return out["g"], out["d"]


def make_corpus(rows: int, size: int, seed: int, device) -> torch.Tensor:
    """``(rows, 2, size, size)`` float32 images from the seed, in chunks."""
    g = device_generator(seed, 11, device)
    data = torch.empty((rows, 2, size, size), device=device)
    for a in range(0, rows, 64):
        data[a : a + 64].uniform_(-1.0, 1.0, generator=g)
    return data


def make_indices(rows: int, batch: int, iterations: int, seed: int, device) -> torch.Tensor:
    """``(iterations, batch)`` row indices: each epoch one permutation of
    the corpus, cut into batches (the remainder dropped)."""
    g = device_generator(seed, 12, device)
    per = rows // batch
    out = []
    while len(out) * per < iterations:
        out.append(torch.randperm(rows, generator=g, device=device)[: per * batch].reshape(per, batch))
    return torch.cat(out)[:iterations]


def draw_noise(g, mcfg, batch: int, device):
    """``(z, eps, zg)``: NHWC latents and the penalty's mixing weights."""
    shape = (batch, mcfg.latent_height, mcfg.latent_width, mcfg.rand_channels)
    z = torch.randn(shape, generator=g, device=device)
    eps = torch.rand((batch, 1, 1, 1), generator=g, device=device)
    return z, eps, torch.randn(shape, generator=g, device=device)


def iteration_work(mcfg, tcfg, stage: int):
    """Per n_critic cycle: ``(conv_units, wgrad_units)`` (see ``work.py``)."""
    size = 4 * 2**stage
    disc_stage = len(mcfg.disc_channels) - 2 - stage
    lat = (mcfg.latent_height, mcfg.latent_width)
    critic = critic_convs(mcfg.disc_channels, tcfg.batch_size, size, disc_stage)
    gen = generator_train_convs(mcfg.gen_channels, tcfg.batch_size, lat, stage)
    passes, wgrads = [], []
    for i in range(tcfg.n_critic):
        p, w = train_iteration_units(critic, gen, with_gen=i == 0)
        passes += p
        wgrads += w
    return passes, wgrads


def setup(run):
    from musicgan_tpu_torch.ops import _build
    from musicgan_tpu_torch.ops.autotune import resolve_conv_impl
    from musicgan_tpu_torch.train.step import build_step, init_train_state

    cfg, tr, dev = run.config, run.traffic, run.device
    mcfg, tcfg = model_config(cfg), train_config(cfg)
    stage, batch = int(cfg["stage"]), tcfg.batch_size
    if dev.type == "cuda":
        run.log(f"kernels built or found in {_build.build_all():.2f} s")
    state = init_train_state(0, mcfg, tcfg, device=dev)
    w_g, w_d = make_weights(mcfg, run.seed, dev)
    with torch.no_grad():
        for net, weights in ((state.gen, w_g), (state.disc, w_d)):
            own = dict(net.named_parameters())
            if set(own) != set(weights) or any(own[k].shape != weights[k].shape for k in own):
                raise RuntimeError("the program's parameters are not the reference's leaves")
            for k, p in own.items():
                p.copy_(weights[k])
    rows, size = int(tr["corpus_rows"]), 4 * 2**stage
    corpus = make_corpus(rows, size, run.seed, dev)
    idx = make_indices(rows, batch, int(tr["max_iterations"]), run.seed, dev)
    g = device_generator(run.seed, 13, dev)
    steps = {w: build_step(stage, w, mcfg, tcfg, device_data=True, device=dev) for w in (True, False)}
    impl = resolve_conv_impl(mcfg, (batch, mcfg.latent_height, mcfg.latent_width, mcfg.rand_channels), stage,
                             for_training=True, train_cfg=tcfg, device=dev).conv_impl
    run.log(f"train conv_impl {impl}")
    alpha = float(tr["alpha"])
    first = int(tr["first_steps"])
    noise, losses, grad_norms = [], [], {}
    b1 = tcfg.betas[0]
    for i in range(first):
        noise.append(draw_noise(g, mcfg, batch, dev))
        do_g = i % tcfg.n_critic == 0
        state, m = steps[do_g](state, corpus, idx[i], alpha, noise=noise[-1])
        losses.append([m["disc_loss"] + m["grad_pen"]] + ([m["gen_loss"]] if do_g else []))
        if i == 0:
            for net, opt in (("g", state.opt_gen), ("d", state.opt_disc)):
                grad_norms[net] = {k: torch.linalg.vector_norm(mu / (1.0 - b1)) for k, mu in opt.mu.items()}
    changes = {}
    with torch.no_grad():
        for net, module, weights in (("g", state.gen, w_g), ("d", state.disc, w_d)):
            changes[net] = {k: torch.linalg.vector_norm(p - weights[k]) for k, p in module.named_parameters()}
    kept_rows = corpus[idx[:first].reshape(-1)].clone()
    return {"state": state, "corpus": corpus, "idx": idx, "steps": steps, "g": g, "mcfg": mcfg, "tcfg": tcfg,
            "alpha": alpha, "first": first, "noise": noise, "losses": losses, "grad_norms": grad_norms,
            "changes": changes, "rows": kept_rows, "impl": impl, "stage": stage}


def window(run, st):
    dev, steps, tcfg = run.device, st["steps"], st["tcfg"]
    state, corpus, idx, alpha = st["state"], st["corpus"], st["idx"], st["alpha"]
    pending = deque()
    i, done = st["first"], 0
    with run.measure():
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        t_last = t0
        while True:
            noise = draw_noise(st["g"], st["mcfg"], tcfg.batch_size, dev)
            with run.span("port_bench.train_step"):
                state, _ = steps[i % tcfg.n_critic == 0](state, corpus, idx[i % len(idx)], alpha, noise=noise)
            pending.append(Completion(dev))
            i += 1
            if len(pending) > 1:
                with run.span("port_bench.wait"):
                    t_last = pending.popleft().wait()
                done += 1
                if t_last >= deadline and done % tcfg.n_critic == 0:
                    break
    for mark in pending:
        mark.wait()
    window_s = t_last - t0
    run.end_to_end["train_samples_per_s"] = done * tcfg.batch_size / window_s
    run.attempted, run.failed = i - st["first"], 0
    passes, wgrads = iteration_work(st["mcfg"], tcfg, st["stage"])
    peak = PEAK_FLOPS["float32"]
    run.facts.update(iterations_completed=done, window_s=window_s, conv_impl=st["impl"],
                     units_done=done / tcfg.n_critic, conv_least_s=least_s(passes, peak),
                     wgrad_least_s=least_s(wgrads, peak), flops=total(passes).flops + total(wgrads).flops,
                     peak_flops=peak)


def _floats(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()}


def first_readings(st) -> tuple:
    """The program's first steps as numbers: ``(losses, grads, changes)``
    (see :func:`gaps`); the program's state is then dropped."""
    readings = ([[float(v) for v in step] for step in st["losses"]],
                {net: _floats(d) for net, d in st["grad_norms"].items()},
                {net: _floats(d) for net, d in st["changes"].items()})
    for key in ("state", "corpus", "steps", "idx"):
        st.pop(key, None)
    return readings


def check(run, st):
    """Read the program's first steps, free it, run the reference's."""
    prog = first_readings(st)
    free_device(run.device)
    record(run, prog, reference_steps(run, st, "float32"))


def reference_steps(run, st, precision: str, rows_at_once: int = 6, half: bool = False):
    """The reference's first steps from the seed's weights with the
    setup's rows and noise, in ``precision`` (``"float32"``, or a
    control's); with ``half``, on the first half of each batch only (the
    fault "half of the batch left out, the mean taken over the rest")."""
    from ..reference.lower import operand_rounding

    mcfg, tcfg, dev = st["mcfg"], st["tcfg"], run.device
    dtype = torch.float64 if precision == "float64" else torch.float32
    w_g, w_d = (
        {k: v.to(dtype) for k, v in w.items()} for w in make_weights(mcfg, run.seed, dev)
    )
    p0 = {"g": {k: v.clone() for k, v in w_g.items()}, "d": {k: v.clone() for k, v in w_d.items()}}
    b1, b2 = tcfg.betas
    opt_g = ref.Adam(w_g, tcfg.gen_lr, b1, b2)
    opt_d = ref.Adam(w_d, tcfg.disc_lr, b1, b2)
    rounding = None if precision in ("float32", "float64") or (precision == "tf32" and dev.type == "cuda") \
        else operand_rounding(precision)
    batch, losses, grads = tcfg.batch_size, [], {}
    used = batch // 2 if half else batch
    with numerics(precision, dev):
        for i in range(st["first"]):
            do_g = i % tcfg.n_critic == 0
            noise = tuple(t[:used].to(dtype) for t in st["noise"][i])
            out = ref.iteration(w_g, w_d, opt_g, opt_d, st["rows"][i * batch : i * batch + used].to(dtype), noise,
                                st["stage"], st["alpha"], do_g, mcfg.leaky_slope, mcfg.pixel_norm_eps,
                                tcfg.grad_penalty_weight, rows=rows_at_once, rounding=rounding)
            losses.append([out["critic_loss"]] + ([out["gen_loss"]] if do_g else []))
            if i == 0:
                for net, key in (("g", "gen_grads"), ("d", "disc_grads")):
                    got = out.get(key, {})
                    grads[net] = {k: (None if g is None else float(torch.linalg.vector_norm(g))) for k, g in got.items()}
    changes = {net: {k: float(torch.linalg.vector_norm(w[k] - p0[net][k])) for k in w}
               for net, w in (("g", w_g), ("d", w_d))}
    return losses, grads, changes


def gaps(prog, refr) -> dict:
    """The numbers the cell can compare.  ``prog`` and ``refr``: ``(losses,
    grads, changes)``: each first step's losses, and by leaf the norms of
    the first gradient and of the change.  ``loss_gap``: the losses' worst
    gap; ``loss_gap_first``: the first step's critic loss's, taken at the
    initial weights on both sides.  Of the first gradient and of the change,
    the gap of the worst leaf (with its name) and of the median leaf, over
    both networks (``grad_*``, ``change_*``) and over the critic's leaves
    alone (``critic_grad_*``): the critic's first gradient is taken at the
    initial weights, the generator's against the critic after its first
    Adam step.  The configuration's ``limits`` say which are compared
    (``PERF.md`` says why)."""
    losses, grads, changes = prog
    ref_losses, ref_grads, ref_changes = refr
    flat = [v for step in losses for v in step]
    ref_flat = [v for step in ref_losses for v in step]
    out = {"loss_gap": compare.loss_gap(flat, ref_flat), "loss_gap_first": compare.loss_gap(flat[:1], ref_flat[:1])}
    g_gaps, c_gaps = {}, {}
    for net in ("g", "d"):
        if net in ref_grads:
            leaves = compare.moving_leaves(ref_grads[net])
            rg = {k: ref_grads[net][k] for k in leaves}
            g_gaps.update({f"{net}.{k}": v for k, v in compare.leaf_gaps(grads[net], rg, leaves).items()})
            c_gaps.update({f"{net}.{k}": v for k, v in compare.leaf_gaps(changes[net], ref_changes[net], leaves).items()})
    critic = {k: v for k, v in g_gaps.items() if k.startswith("d.")}
    for name, per_leaf in (("grad", g_gaps), ("change", c_gaps), ("critic_grad", critic)):
        worst = max(per_leaf, key=per_leaf.get) if per_leaf else ""
        out[f"{name}_gap"] = per_leaf.get(worst, float("inf"))
        out[f"{name}_leaf"] = worst
        out[f"{name}_gap_median"] = statistics.median(per_leaf.values()) if per_leaf else float("inf")
    return out


def record(run, prog, refr) -> None:
    g = gaps(prog, refr)
    run.facts.update({k: v for k, v in g.items() if k not in run.config["limits"]})
    for name, limit in run.config["limits"].items():
        run.checks[name] = (g[name], limit)


__all__ = ["setup", "window", "check", "first_readings", "record", "make_weights", "make_corpus", "make_indices", "draw_noise",
           "reference_steps", "gaps", "train_config", "iteration_work"]
