"""The training workflow: progressive-growing WGAN-GP on one device, or
data parallel over a process group with one process a card (counterpart of
``musicgan_tpu/train/loop.py``; reference ``train.py:18-278``).

* one train step per (stage, with-G) pair, selected on the host by the
  static n_critic schedule (``train/step.py``);
* the corpus lives on the device when it fits (indices go to the step), or
  streams from the host with the per-stage scaling done there;
* ``chunk_steps`` iterations go to the device per call where no stage
  switch, save or ``max_iters`` falls inside them; the cadence metrics are
  read back only after the next chunk has been launched;
* full-state checkpoints every ``save_every`` iterations and on
  SIGTERM/SIGUSR1, WITH bit-exact resume (the reference cannot resume);
* data parallelism (``parallel.initialize_distributed``, then ``mesh=
  "auto"``): each rank streams its rows of every global batch (or holds its
  row range of the resident corpus), the train step averages the gradients
  over the ranks, and the replicated state stays equal on every rank.  The
  lead (rank 0) alone writes checkpoints, previews, the CSV and the log;
  every rank fetches the cadence metrics, beats its own watchdog and agrees
  on preemption and on the dataset's size at each epoch.

Where JAX trains over a mesh of devices in one process, the port runs one
process a card: an explicit ``parallel.Mesh`` for training raises.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..audio.dataset import SpectrogramDataset, batch_indices, batch_iterator
from ..audio.host_pipeline import prepare_batch
from ..config import ModelConfig, TrainConfig
from ..device import resolve_device
from ..parallel import mesh as pmesh
from ..utils.metrics import MetricLogger
from ..utils.watchdog import (
    EXIT_STALLED,
    StallWatchdog,
    is_distributed_failure,
    is_runtime_error,
)
from .grower import Grower
from .saver import Saver
from .step import TrainState, build_chunk_step, build_step, data_group, init_train_state

__all__ = ["train", "PREEMPTED"]

# Preemption-aware checkpointing (SURVEY §5: failure recovery).  Schedulers
# announce maintenance/preemption with a signal and a grace window; the
# production pattern is: catch it, flush a checkpoint at the next iteration
# boundary, exit retryable, and let the scheduler resume elsewhere.  The
# train loop polls this event once per iteration; the CLI exits
# ``EXIT_STALLED`` (75, EX_TEMPFAIL: the same retry contract the stall
# watchdog uses) when it is set after ``train`` returns.
PREEMPTED = threading.Event()
_PREEMPT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


def _install_preemption_handlers():
    """Arm SIGTERM/SIGUSR1 -> PREEMPTED for the duration of a run.

    Returns the previous handlers for restoration (``None`` when not on
    the main thread, where CPython forbids ``signal.signal``)."""
    PREEMPTED.clear()  # a stale flag from an earlier run must not stop
    # this one: cleared even off the main thread, where no handlers can
    # be installed.
    if threading.current_thread() is not threading.main_thread():
        return None

    def _on_signal(signum, frame):
        PREEMPTED.set()
        print(
            f"[preempt] caught {signal.Signals(signum).name}; will "
            "checkpoint at the next iteration boundary and stop",
            flush=True,
        )

    return {s: signal.signal(s, _on_signal) for s in _PREEMPT_SIGNALS}


def _restore_preemption_handlers(prev) -> None:
    if prev is not None:
        for s, h in prev.items():
            signal.signal(s, h)


def _train_group(mesh, axis: str):
    """The process group the run is data parallel over, or None: ``"auto"``
    takes the group ``parallel.initialize_distributed`` joined where it has
    more than one process; ``None`` is one process (and refuses to run as
    one of several); a ``parallel.Group`` is taken as given, and a
    ``parallel.Mesh`` raises (``train/step.py::data_group``)."""
    if isinstance(mesh, str) and mesh == "auto":
        return pmesh.process_group(axis)
    if mesh is None:
        if pmesh.process_count() > 1:
            raise ValueError(
                f"mesh=None trains in one process, but this one is rank {pmesh.process_index()} "
                f"of {pmesh.process_count()}: pass mesh='auto'"
            )
        return None
    return data_group(mesh)


def _fetch_later(values: torch.Tensor):
    """Start copying ``values`` to the host and return ``get() -> list``.
    On the card the copy is queued now, behind the work that produced the
    values and ahead of whatever is launched next, so a later ``get`` waits
    for that work only."""
    if values.device.type != "cuda":
        return values.tolist
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def get():
        done.synchronize()
        return host.tolist()

    return get


def train(
    run_name: str,
    input_dataset_path: str,
    output_dir: str,
    train_cfg: TrainConfig = TrainConfig(),
    model_cfg: ModelConfig = ModelConfig(),
    resume: bool = False,
    max_iters: Optional[int] = None,
    mesh="auto",
    device: str | torch.device | None = None,
) -> TrainState:
    """Run (or resume) progressive WGAN-GP training; returns final state.

    ``device``: ``cuda`` by default (raises without a GPU); ``"cpu"`` runs
    the kernels' plain versions.  ``mesh``: ``"auto"`` (default) is data
    parallel over the process group where ``parallel.initialize_distributed``
    joined one of more than one process, else one device; ``None`` forces
    one process; an explicit ``parallel.Mesh`` of devices raises, since the
    port trains one process a card.  In a group every rank calls ``train``
    with the same arguments; ``device`` "cuda" is then the card the group
    gave the rank.
    """
    device = resolve_device(device)
    group = _train_group(mesh, train_cfg.data_axis)
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    if group is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # the rank's card
    lead = rank == 0
    dataset = SpectrogramDataset(input_dataset_path)
    if len(dataset) < train_cfg.batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} samples < batch {train_cfg.batch_size}"
        )
    if train_cfg.batch_size % world:  # one device a process: devices = hosts
        raise ValueError(f"batch {train_cfg.batch_size} not divisible by {world} devices / hosts")

    # Device-resident dataset mode: corpus in device memory once, indices
    # per step (see TrainConfig.device_dataset).
    if train_cfg.device_dataset_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"device_dataset_dtype must be float32 or bfloat16, got "
            f"{train_cfg.device_dataset_dtype}"
        )
    dev_bf16 = train_cfg.device_dataset_dtype == "bfloat16"

    def resident_bytes() -> int:
        # bf16 residency halves the bytes; budget-check the RESIDENT size,
        # per device: in a group each rank holds 1/world of the corpus
        return dataset.nbytes() // (2 if dev_bf16 else 1) // world

    # In a group "auto" stays off, as JAX's stays off under a mesh, and "on"
    # shards the corpus over the ranks of one host.
    use_dev_data = train_cfg.device_dataset == "on" or (
        train_cfg.device_dataset == "auto"
        and group is None
        and resident_bytes() <= train_cfg.device_dataset_budget_bytes
    )
    if use_dev_data and group is not None and len({h for h, _ in pmesh.hosts()}) > 1:
        raise ValueError("device_dataset='on' requires a single-host run")

    data_dev = None
    resident_n = 0  # LOGICAL sample count of the resident corpus (it may
    # lag len(dataset) when a grown corpus stopped fitting the budget; in a
    # group the shipped array carries up to world - 1 pad rows, never drawn)

    def ship_corpus():
        """(Re-)ship the corpus to the device; frees any prior resident
        buffer FIRST (device memory need not hold two copies: it is rebuilt
        from host data, so nothing is lost on a failed upload).  The cast
        to bfloat16 happens on the HOST, so exactly the resident bytes are
        copied."""
        nonlocal data_dev, resident_n
        staged = dataset.as_array(
            "bfloat16" if dev_bf16 else np.float32, pad_rows=pmesh.pad_rows(len(dataset), world)
        )
        if group is not None:  # this rank's row range only
            staged = np.ascontiguousarray(staged[pmesh.data_sharding(group, len(dataset))[rank]])
        staged = torch.from_numpy(staged)
        if dev_bf16:
            staged = staged.view(torch.bfloat16)
        data_dev = None
        data_dev = staged.to(device)
        resident_n = len(dataset)

    if use_dev_data:
        ship_corpus()

    state = init_train_state(train_cfg.seed, model_cfg, train_cfg, device=device)
    grower = Grower(
        fadein_lengths=train_cfg.fadein_lengths,
        train_lengths=train_cfg.train_lengths,
        max_stage=train_cfg.max_stage,
    )
    # The state is replicated: the lead writes each save, and every rank
    # waits for it (the saver's counters advance on every rank).
    saver = Saver(output_dir, train_cfg, model_cfg, lead=lead,
                  sync=pmesh.host_barrier if group is not None else None)
    # Observability is per run, not per process: only the lead writes the
    # CSV and the previews and prints.
    logger = (
        MetricLogger(
            output_dir,
            train_cfg.metric_window,
            tb_dir=train_cfg.tb_dir,
            mlflow_uri=train_cfg.mlflow_uri,
            run_name=run_name,
            params=dataclasses.asdict(train_cfg),
        )
        if lead
        else None
    )

    # Failure detection (SURVEY §5): a wedged device never returns from a
    # synchronisation, so progress is witnessed through real device->host
    # fetches (metric reads and checkpoint writes) and their absence past
    # the timeout exits 75 for a supervised restart (utils/watchdog.py).
    # Every rank runs one and fetches the cadence metrics: a lead's death
    # that leaves the others blocked in a collective then ends them too.
    watchdog = StallWatchdog(train_cfg.stall_timeout_s)
    preempted = PREEMPTED
    _prev_sig = _install_preemption_handlers()

    start_epoch = 0
    # Bit-exact resume: the checkpoint records how many batches of the
    # interrupted epoch were consumed, so the resumed run replays the
    # remainder of that epoch's (seed+epoch)-deterministic order instead
    # of restarting it.  With a static corpus the resumed run is then
    # numerically identical to an uninterrupted one (tested); a corpus
    # still growing via streaming ingest naturally re-shuffles.
    resume_skip_batches = 0
    if resume:
        # Every rank restores the lead's latest save, its rng state included.
        latest = pmesh.host_broadcast(saver.ckpt.latest())
        if latest is not None:
            state, meta = saver.ckpt.restore(latest, state)
            if train_cfg.ema_decay == 0 and state.gen_ema is not None:
                # Resumed WITHOUT --ema-decay from an EMA-carrying run: a
                # kept-but-never-updated EMA would silently freeze every
                # later preview/generate at the resume point (they prefer
                # gen_ema when present): drop it instead.
                if lead:
                    print(
                        "[resume] checkpoint carries generator EMA but "
                        "ema_decay=0; discarding it (pass --ema-decay to "
                        "keep updating it)"
                    )
                state.gen_ema = None
            grower.load_state_dict(meta["grower"])
            # A save is written before its iteration's samples are counted
            # (post_iteration: save, then grow), so the saved grower lags
            # the saved state by one batch.  The uninterrupted run counted
            # them right after the save; count them here, or the resumed
            # run's fade-in and stage switches come one iteration late.
            grower.grow(train_cfg.batch_size)
            saver.counter = int(meta["saver_counter"])
            saver.curr_save = latest + 1
            start_epoch = int(meta.get("epoch", 0))
            resume_skip_batches = int(meta.get("epoch_batch_pos", 0))
            if lead:
                print(
                    f"[resume] save_{latest}: iter={int(state.iter_idx)} "
                    f"stage={grower.curr_grow} epoch={start_epoch}"
                    + (
                        f" (+{resume_skip_batches} batches into the epoch)"
                        if resume_skip_batches
                        else ""
                    )
                )

    max_stage = (
        train_cfg.max_stage
        if train_cfg.max_stage is not None
        else model_cfg.n_stages - 1
    )
    pre_scaled = train_cfg.host_pipeline and not use_dev_data

    # A step's first build resolves conv_impl "auto" (ops/autotune.py): on
    # the card it times the four train impls on this stage's step, beating
    # the watchdog as it goes, unless the persisted table has the winner.
    # In a group the lead measures and the others take its winner.
    def get_step(stage: int, with_gen: bool):
        return build_step(
            stage, with_gen, model_cfg, train_cfg, mesh=group, data_axis=train_cfg.data_axis,
            pre_scaled=pre_scaled, device_data=use_dev_data, device=device,
        )

    def get_chunk_step(stage: int):
        return build_chunk_step(
            stage, train_cfg.chunk_steps, model_cfg, train_cfg, mesh=group, data_axis=train_cfg.data_axis,
            pre_scaled=pre_scaled, device_data=use_dev_data, device=device,
        )

    def steps_until_boundary() -> int:
        """How many iterations can run before a stage switch, a checkpoint
        firing, or max_iters: a chunk must not straddle any of them
        (except as its final iteration)."""
        out = []
        to_grow = grower.samples_to_next_stage()
        if to_grow is not None:
            out.append(to_grow // train_cfg.batch_size + 1)
        out.append(
            train_cfg.save_every - (saver.counter % train_cfg.save_every)
        )
        if max_iters is not None:
            out.append(max_iters - iter_idx)
        return max(1, min(out))

    iter_idx = int(state.iter_idx)
    epoch_batch_pos = resume_skip_batches  # batches consumed of the current epoch
    t_start = time.perf_counter()
    done = False
    # Wall rate by stage: iterations and seconds since the stage began,
    # read at each stage switch and at the end (saves and previews included).
    stage_mark = [iter_idx, t_start]

    def stage_rate() -> str:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        n, dt = iter_idx - stage_mark[0], now - stage_mark[1]
        stage_mark[:] = [iter_idx, now]
        return f"{n} iterations in {dt:.3f} s = {n / max(dt, 1e-9):.3f} steps/s"

    if lead:
        print(
            f"[train:{run_name}] {len(dataset)} samples, batch "
            f"{train_cfg.batch_size}, {world} device(s) ({device}"
            f"{'' if group is None else ', one a process'}), "
            f"{world} host(s), start stage {grower.curr_grow}"
        )

    def log_metrics(epoch, m_iter, m_stage, keys, get, m_gen, alpha):
        # ``get`` finishes a device->host fetch: the watchdog's evidence
        # of progress.  One batched transfer, not a read per metric.  Every
        # rank fetches; only the lead logs.
        host_m = dict(zip(keys, get()))
        watchdog.beat()
        if logger is None:
            return
        if not m_gen:
            host_m.pop("gen_loss", None)
            host_m.pop("e_gen", None)
        logger.push(host_m)
        row = logger.log_row(m_iter, m_stage, extra={"alpha": alpha})
        elapsed = time.perf_counter() - t_start
        print(
            f"e{epoch:03d} it{m_iter:07d} s{m_stage} "
            + " ".join(
                f"{k}={v:.4f}" for k, v in row.items()
                if k not in ("step", "stage", "wall_s")
            )
            + f" [{elapsed:.1f}s]",
            flush=True,
        )

    def meta_dict(epoch):
        return {
            "grower": grower.state_dict(),
            "epoch": epoch,
            "epoch_batch_pos": epoch_batch_pos,
            "iter_idx": iter_idx + 1,
            "run_name": run_name,
            "train_cfg": dataclasses.asdict(train_cfg),
        }

    def preempt_agreed() -> bool:
        """The collective preemption decision.  Signals land on the ranks at
        different times, while the flush and the early exit must happen on
        all of them at one iteration boundary, or their collectives no
        longer match: every rank calls this at the same boundaries, and any
        rank's signal preempts the whole run."""
        if group is None:
            return preempted.is_set()
        if any(pmesh.host_allgather(preempted.is_set())):
            preempted.set()  # the same exit 75 on every rank
            return True
        return False

    def post_iteration(epoch, stage, alpha, at_boundary=True):
        """Bookkeeping after each iteration: save cadence, counters, growth
        (reference train.py:248-272 order).

        ``at_boundary`` is False for all but the last iteration of a
        chunked dispatch: ``state`` already reflects the whole chunk, so a
        preemption flush mid-chunk would checkpoint meta (iter_idx,
        grower) that lags the device state: the flush waits for the
        chunk's final bookkeeping call."""
        nonlocal iter_idx, done, epoch_batch_pos
        epoch_batch_pos += 1  # this iteration's batch is now consumed
        stopping = at_boundary and preempt_agreed()
        if saver.request_save(state, stage, alpha, meta=meta_dict(epoch)):
            watchdog.beat()  # the checkpoint write read the device state
        elif stopping:
            # Preemption warning (SIGTERM/SIGUSR1): flush a checkpoint at
            # this iteration boundary even off the save cadence, so the
            # relaunch loses zero iterations.
            saver.save_now(state, stage, alpha, meta=meta_dict(epoch))
        iter_idx += 1
        if stopping:
            done = True
            return
        if max_iters is not None and iter_idx >= max_iters:
            done = True
            return
        # ProGAN growth: counters advance by the global batch.
        if grower.grow(train_cfg.batch_size) and grower.curr_grow <= max_stage and lead:
            print(
                f"[grow] stage -> {grower.curr_grow} "
                f"(size {grower.image_size}x{grower.image_size}), "
                f"curr_save = {saver.curr_save - 1}; "
                f"stage {grower.curr_grow - 1}: {stage_rate()}",
                flush=True,
            )

    # --- deferred metric flush (1-chunk-deep pipeline) -------------------
    # Kernel launches are asynchronous: a chunk call returns with the
    # device still working; the ONLY forced sync in steady state is the
    # cadence metric fetch.  Reading chunk k's scalars BEFORE launching
    # chunk k+1 would leave the device idle for the fetch and the host's
    # bookkeeping.  Instead the copy of a cadence row is queued right
    # behind its chunk, the row is queued here, and it is read right AFTER
    # the next chunk is launched, so the wait overlaps device compute.
    # Costs: log lines / watchdog beats lag by at most one chunk.
    pending_logs: list = []

    def flush_logs():
        while pending_logs:
            log_metrics(*pending_logs.pop(0))

    def to_device(x_np: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x_np)).to(device)

    def run_single(epoch, x_raw):
        nonlocal state
        flush_logs()
        stage = min(grower.curr_grow, max_stage)
        alpha = grower.alpha
        # The step sees the fade-in weight rounded to float32, as a chunk's
        # array of weights holds it (single and chunked stepping agree).
        alpha32 = float(np.float32(alpha))
        with_gen = iter_idx % train_cfg.n_critic == 0

        if use_dev_data:  # x_raw is an index batch
            state, metrics = get_step(stage, with_gen)(state, data_dev, x_raw, alpha32)
        else:
            if train_cfg.host_pipeline:
                x_raw = prepare_batch(x_raw, 4 * 2**stage)
            state, metrics = get_step(stage, with_gen)(state, to_device(x_raw), alpha32)
        # Read metrics on the cadence only (no per-step device sync).
        if iter_idx % train_cfg.log_every == 0:
            keys = list(metrics)
            get = _fetch_later(torch.stack([metrics[k] for k in keys]))
            log_metrics(epoch, iter_idx, stage, keys, get, with_gen, alpha)
        post_iteration(epoch, stage, alpha)

    def run_chunk(epoch, items):
        """K iterations in one call; preconditions guaranteed by
        steps_until_boundary: no stage switch and no checkpoint firing
        except at the chunk's final iteration."""
        nonlocal state
        k = len(items)
        stage = min(grower.curr_grow, max_stage)
        alphas = np.array(
            grower.alphas_for_next(k, train_cfg.batch_size), np.float32
        )
        gen_mask = [(iter_idx + i) % train_cfg.n_critic == 0 for i in range(k)]
        alpha_list = [float(a) for a in alphas]
        if use_dev_data:  # items are index batches
            state, mstack = get_chunk_step(stage)(
                state, data_dev, np.stack(items), alpha_list, gen_mask
            )
        else:
            if train_cfg.host_pipeline:
                items = [prepare_batch(b, 4 * 2**stage) for b in items]
            state, mstack = get_chunk_step(stage)(
                state, to_device(np.stack(items)), alpha_list, gen_mask
            )
        rows = [i for i in range(k) if (iter_idx + i) % train_cfg.log_every == 0]
        keys = list(mstack)
        get = None
        if rows:  # queue the copy behind this chunk, ahead of the next
            get = _fetch_later(torch.stack([mstack[key] for key in keys]))  # (keys, K)
        # The new chunk is in flight: NOW read the previous chunk's
        # cadence rows (its results are long since complete).
        flush_logs()
        base_iter = iter_idx
        for i in range(k):
            if i in rows:
                pending_logs.append((
                    epoch, base_iter + i, stage, keys,
                    (lambda i=i: [col[i] for col in get()]),
                    gen_mask[i], alpha_list[i],
                ))
            post_iteration(
                epoch, stage, alpha_list[i], at_boundary=(i == k - 1)
            )
            if done:
                break

    chunk_n = max(1, train_cfg.chunk_steps)
    buf: list = []

    def run_epochs():
        for epoch in range(start_epoch, train_cfg.nb_epoch):
            if done:
                break
            run_one_epoch(epoch)

    def run_one_epoch(epoch):
        nonlocal buf, epoch_batch_pos, resume_skip_batches
        # Bit-exact resume: fast-forward the resumed epoch's deterministic
        # (seed+epoch) order past the batches the interrupted run consumed.
        skip = resume_skip_batches if epoch == start_epoch else 0
        resume_skip_batches = 0
        epoch_batch_pos = skip
        # Streaming ingest: pick up shards a concurrent writer has
        # appended since the last epoch.  In a group the batches derive
        # from len(dataset), so the ranks must not see different snapshots
        # of a still-growing index: each offers what its index holds, all
        # refresh to the least, and a rank whose index was unreadable
        # mid-rewrite (it kept a smaller view) shrinks the others to its
        # count in a second agreement.
        if group is None:
            grew = dataset.refresh()
        else:
            grew = dataset.refresh(limit=min(pmesh.host_allgather(dataset.peek_total())))
            realized = min(pmesh.host_allgather(len(dataset)))
            if realized != len(dataset):
                dataset.refresh(limit=realized)
                grew = False
        if grew:
            if lead:
                print(f"[dataset] grew to {len(dataset)} samples", flush=True)
            if use_dev_data:
                # The budget was checked at startup; a still-growing corpus
                # can outgrow it mid-run.  Stop re-shipping rather than
                # run the device out of memory: training continues on the
                # resident snapshot.
                if resident_bytes() <= train_cfg.device_dataset_budget_bytes:
                    # Re-ship once.  A grown resident corpus is a large
                    # upload with no metric fetch in sight; beat on both
                    # sides so the upload gets a full stall window of its
                    # own and the steady-state clock doesn't inherit its
                    # duration.
                    watchdog.beat()
                    ship_corpus()
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    watchdog.beat()
                elif lead:
                    print(
                        "[dataset] grown corpus exceeds "
                        "device_dataset_budget_bytes; keeping the resident "
                        f"{resident_n}-sample snapshot",
                        flush=True,
                    )
        epoch_batches = (
            batch_indices(
                # Index into the RESIDENT corpus' rows: it may lag
                # len(dataset) when a grown corpus stopped fitting the
                # budget above.
                resident_n,
                train_cfg.batch_size,
                seed=train_cfg.seed + epoch,
                skip=skip,  # index-level: no data touched for skipped batches
            )
            if use_dev_data
            else batch_iterator(
                dataset,
                train_cfg.batch_size // world,
                seed=train_cfg.seed + epoch,
                host_id=rank,
                num_hosts=world,
                skip=skip,
            )
        )
        for x_raw in epoch_batches:
            if chunk_n == 1:
                run_single(epoch, x_raw)
            else:
                buf.append(x_raw)
                if len(buf) < chunk_n:
                    continue
                if steps_until_boundary() >= chunk_n:
                    run_chunk(epoch, buf)
                    buf = []
                else:  # near a boundary: drain one-by-one
                    run_single(epoch, buf.pop(0))
            if done:
                break
        # epoch remainder drains as single steps
        while buf and not done:
            run_single(epoch, buf.pop(0))

    try:
        run_epochs()
        flush_logs()  # cadence rows deferred past the final dispatch
    except Exception as e:
        # A dying runtime under us is exactly as retryable as a stall.  In
        # one process the exception must BE a device-runtime error, not
        # just match the markers by message: a BrokenPipeError from a
        # closed preview stream, or any library error mentioning
        # "unavailable", must keep propagating as a real crash rather than
        # burn a restart budget.  In a group the broader match: a dead peer
        # surfaces on the others as a gloo or NCCL error of the next
        # collective, which must exit 75 so that every rank's supervisor
        # relaunches (an rc-1 survivor would leave the relaunched peers
        # waiting for it at the rendezvous).
        retryable = is_distributed_failure(e) and (group is not None or is_runtime_error(e))
        if retryable:
            print(
                f"[train] retryable runtime failure "
                f"({type(e).__name__}: {e}); exiting {EXIT_STALLED} "
                "for supervised restart from the latest checkpoint",
                flush=True,
            )
            if group is not None:
                # Not SystemExit in a group: unwinding through interpreter
                # teardown runs the process group's own shutdown, which
                # waits on the dead peer.  Tear down what the finally would,
                # then exit with the contract code at once, as the stall
                # watchdog does.
                import os
                import sys

                try:
                    watchdog.close()
                    _restore_preemption_handlers(_prev_sig)
                    if logger is not None:
                        logger.close()
                    sys.stdout.flush()
                    sys.stderr.flush()
                finally:
                    os._exit(EXIT_STALLED)
            raise SystemExit(EXIT_STALLED) from e
        raise
    finally:
        watchdog.close()
        _restore_preemption_handlers(_prev_sig)
        if logger is not None:
            logger.close()
    rate = stage_rate()
    if lead:
        print(
            f"[train:{run_name}] stopped at iter {iter_idx}; "
            f"stage {min(grower.curr_grow, max_stage)}: {rate}",
            flush=True,
        )
    if preempted.is_set() and lead:
        print(
            f"[preempt] stopped at iter {iter_idx} with a flushed "
            "checkpoint; exit retryable and resume with --resume",
            flush=True,
        )
    return state
