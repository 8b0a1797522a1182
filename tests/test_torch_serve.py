"""The port's serving layer (``musicgan_tpu_torch/serve.py``) on the CPU:
every case of ``tests/test_serve.py`` (the two long-clip ones on a mesh of
eight CPU devices, as JAX's on conftest's eight virtual devices), parity
with the JAX package's ``synthesize_fn`` on the same latents and weights,
the device and mesh rules, failures reaching the futures, and the ``serve``
CLI.

TINY_MODEL's widths, stage 2, nb_vec 1: the vocoder upsamples every stage
to full 512-bin resolution, so even tiny stages produce real audio."""

import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax

from musicgan_tpu.generate import synthesize_fn as jax_synthesize_fn
from musicgan_tpu.models import init_generator
from musicgan_tpu_torch import generate as generate_mod
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models import Generator, params_from_jax
from musicgan_tpu_torch.parallel import Mesh, make_mesh
from musicgan_tpu_torch.parallel.longclip import join_pieces, sharded_synthesize_fn
from musicgan_tpu_torch.serve import SynthesisService, _make_handler, _next_bucket, serve
from tests.tiny_cfg import TINY_MODEL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_PT = os.path.join(ROOT, "saved_models", "quality_r4", "gen_final.pt")
STAGE = 2
NB_VEC = 1
CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
)
# The repo's waveform bar between the two packages.
TOL_WAVE = 1e-4


def _jax_params():
    return jax.tree_util.tree_map(np.asarray, init_generator(jax.random.PRNGKey(0), TINY_MODEL))


def _tiny_generator() -> Generator:
    gen = Generator(CFG)
    gen.load_state_dict(params_from_jax(_jax_params()))
    return gen


def jax_latents(cfg, nb_vec, nb_music, seed, device):
    """``generate.latents`` with JAX's draws: a serve request's
    (``musicgan_tpu/serve.py``: ``(h, w, C)`` from ``PRNGKey(seed)``) for one
    music, ``generate``'s and ``compare``'s (``(M, h, w, C)``) otherwise."""
    shape = (cfg.latent_height, cfg.latent_width * nb_vec, cfg.rand_channels)
    key = jax.random.PRNGKey(seed)
    z = jax.random.normal(key, shape)[None] if nb_music == 1 else jax.random.normal(key, (nb_music, *shape))
    return torch.from_numpy(np.array(z)).to(device)


@pytest.fixture(scope="module")
def service():
    # generous window: thread scheduling on a loaded host can delay the
    # enqueue of "concurrent" requests by tens of ms
    svc = SynthesisService(
        _tiny_generator(), max_batch=4, window_ms=500.0, default_stage=STAGE, device="cpu"
    )
    yield svc
    svc.close()


@pytest.fixture
def http_server(service):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()


def _wave(fut) -> np.ndarray:
    w = fut.result(timeout=300)
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    return w.numpy()


def test_next_bucket():
    assert [_next_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [
        1, 2, 4, 8, 8, 8,
    ]


def test_submit_deterministic_and_distinct(service):
    w1 = _wave(service.submit(seed=7, nb_vec=NB_VEC))
    w2 = _wave(service.submit(seed=7, nb_vec=NB_VEC))
    w3 = _wave(service.submit(seed=8, nb_vec=NB_VEC))
    assert w1.dtype == np.float32 and w1.ndim == 1 and np.isfinite(w1).all()
    np.testing.assert_array_equal(w1, w2)  # same seed -> same audio
    assert not np.array_equal(w1, w3)      # different seed -> different audio


def test_a_request_is_generate_s_draw(service, tmp_path):
    """A request's latent is ``generate(seed=s, nb_music=1)``'s: the same
    batch of one, so the same bits."""
    w = _wave(service.submit(seed=13, nb_vec=NB_VEC))
    z = generate_mod.latents(CFG, NB_VEC, 1, 13, "cpu")
    ref = generate_mod.synthesize_fn(CFG, STAGE)(service.gen, z)[0].numpy()
    np.testing.assert_array_equal(w, ref)


def test_concurrent_requests_microbatch(service):
    """Concurrent same-signature requests coalesce into fewer dispatches,
    and each caller still gets its own seed's waveform."""
    before = service.stats["batches"]
    futs = [service.submit(seed=s, nb_vec=NB_VEC) for s in range(4)]
    waves = [_wave(f) for f in futs]
    n_batches = service.stats["batches"] - before
    assert n_batches < 4  # coalesced (typically 1)
    solo = _wave(service.submit(seed=2, nb_vec=NB_VEC))
    # same seed across different batch buckets: equal up to the plain
    # convolutions' batch-shape-dependent reduction order
    np.testing.assert_allclose(waves[2], solo, atol=1e-5)


def test_mixed_signatures_not_merged(service):
    """Different (stage, nb_vec) signatures must never share a dispatch."""
    before = service.stats_snapshot()
    f1 = service.submit(seed=1, nb_vec=1)
    f2 = service.submit(seed=1, nb_vec=2)
    w1, w2 = _wave(f1), _wave(f2)
    # nb_vec doubles the audio length (up to the constant iSTFT edge term)
    assert abs(w2.shape[0] - 2 * w1.shape[0]) <= 1024
    after = service.stats_snapshot()
    assert after["batches"] - before["batches"] == 2
    assert f"stage{STAGE}/nb_vec2/b1" in after["signatures"]


def test_service_matches_jax_synthesis(monkeypatch, service):
    """With JAX's latents handed in, the service's waveforms, solo and
    micro-batched, lie within the repo's waveform bar (1e-4) of the JAX
    package's ``synthesize_fn`` on the carried-over parameters."""
    monkeypatch.setattr(generate_mod, "latents", jax_latents)
    params = _jax_params()
    futs = [service.submit(seed=s, nb_vec=NB_VEC) for s in (21, 22, 23)]
    waves = [_wave(f) for f in futs]
    solo = _wave(service.submit(seed=24, nb_vec=2))
    for s, w in zip((21, 22, 23), waves):
        z = jax_latents(CFG, NB_VEC, 1, s, "cpu").numpy()
        ref = np.asarray(jax_synthesize_fn(TINY_MODEL, STAGE)(params, z))[0]
        assert w.shape == ref.shape == ((2 * NB_VEC * 2 ** 8 - 1) * 256,)
        assert float(np.abs(ref).max()) > 1e-3  # not a silent pass
        np.testing.assert_allclose(w, ref, atol=TOL_WAVE, rtol=0)
    z = jax_latents(CFG, 2, 1, 24, "cpu").numpy()
    ref = np.asarray(jax_synthesize_fn(TINY_MODEL, STAGE)(params, z))[0]
    np.testing.assert_allclose(solo, ref, atol=TOL_WAVE, rtol=0)


def test_invalid_args(service):
    with pytest.raises(ValueError):
        service.submit(seed=0, nb_vec=0)
    with pytest.raises(ValueError):
        service.submit(seed=0, stage=99)
    # each distinct nb_vec is a batch shape of its own, so unbounded
    # requests are refused
    with pytest.raises(ValueError, match="nb_vec"):
        service.submit(seed=0, nb_vec=service.max_nb_vec + 1)


def test_stats_queue_depth_gauge(service):
    snap = service.stats_snapshot()
    assert "queue_depth" in snap and snap["queue_depth"] >= 0
    fut = service.submit(seed=11, nb_vec=1, stage=STAGE)
    fut.result(timeout=600)
    assert service.stats_snapshot()["queue_depth"] == 0  # drained


def test_mesh_other_than_one_device_raises():
    """``mesh`` is ``None``, ``"auto"`` or a ``parallel.Mesh``: anything
    else raises; ``None`` and ``"auto"`` (on the CPU: no mesh) serve on one
    device, a Mesh is kept."""
    gen = _tiny_generator()
    for mesh in ("data", object(), ("data", 8)):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            SynthesisService(gen, mesh=mesh, device="cpu")
    for mesh in (None, "auto"):  # one device: served
        svc = SynthesisService(gen, mesh=mesh, default_stage=0, device="cpu")
        try:
            assert svc.mesh is None
            assert _wave(svc.submit(seed=1, nb_vec=1)).shape == ((2 * 2 ** 8 - 1) * 256,)
        finally:
            svc.close()
    svc = SynthesisService(gen, mesh=Mesh(("cpu",) * 2), device="cpu")
    try:
        assert svc.mesh.size == 2 and svc.longclip_min_nb_vec == 4
    finally:
        svc.close()


def test_auto_mesh_over_several_cards_raises(monkeypatch):
    """"auto" over four visible cards is a mesh of the four (as JAX's over
    all devices), one card or none no mesh; a clip whose latent width does
    not divide over the mesh raises in the sharded synthesis (the service
    never routes one there)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4)) and mesh.axis == "data"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh() is None and make_mesh([torch.device("cpu")]) is None
    with pytest.raises(ValueError, match="does not divide over 4 shards"):
        sharded_synthesize_fn(Mesh(("cpu",) * 4), CFG, STAGE)(_tiny_generator(), torch.zeros(1, 2, 6, 8))


def test_service_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is usable")
    gen = _tiny_generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SynthesisService(gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(GEN_PT, port=0, warmup=False)


def test_a_failure_in_the_batcher_reaches_the_future_and_http(monkeypatch):
    """A build, launch or out-of-memory error in the batcher thread
    resolves every waiting future with it (over HTTP: a JSON 400), and the
    service keeps serving."""
    def failing(cfg, stage):
        def f(gen, z):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return f

    svc = SynthesisService(_tiny_generator(), window_ms=200.0, default_stage=STAGE, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(svc))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        monkeypatch.setattr(generate_mod, "synthesize_fn", failing)
        futs = [svc.submit(seed=s, nb_vec=1) for s in range(3)]
        for f in futs:
            with pytest.raises(torch.cuda.OutOfMemoryError, match="simulated"):
                f.result(timeout=60)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize?seed=1&nb_vec=1",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400
        assert "simulated" in json.loads(ei.value.read())["error"]
        ei.value.close()
        svc._fns.clear()
        monkeypatch.undo()
        assert np.isfinite(_wave(svc.submit(seed=1, nb_vec=1))).all()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_many_threads_submitting_lose_no_request():
    """Requests from more threads than cores while the interpreter switches
    threads every 10 us: every future resolves to its own seed's waveform
    (within the batch-order bar of 1e-5), and the counters, which the
    batcher updates and ``/stats`` reads, add up."""
    svc = SynthesisService(_tiny_generator(), max_batch=8, window_ms=2.0, default_stage=0, device="cpu")
    n_threads, per_thread = len(os.sched_getaffinity(0)) + 2, 3
    refs = {s: generate_mod.synthesize_fn(CFG, 0)(svc.gen, generate_mod.latents(CFG, 1, 1, s, "cpu"))[0]
            for s in range(4)}
    got, errors = [], []

    def client(i):
        try:
            for j in range(per_thread):
                seed = (i + j) % 4
                got.append((seed, svc.submit(seed=seed, nb_vec=1).result(timeout=120)))
                svc.stats_snapshot()
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        snap = svc.stats_snapshot()
    finally:
        sys.setswitchinterval(switch)
        svc.close()
    assert not errors, errors
    assert len(got) == n_threads * per_thread
    for seed, w in got:
        torch.testing.assert_close(w, refs[seed], atol=1e-5, rtol=0)
    assert snap["requests"] == n_threads * per_thread and snap["queue_depth"] == 0
    assert snap["batched_requests"] <= snap["requests"] and snap["batches"] <= snap["requests"]


def test_batcher_runs_without_autograd(service):
    """``torch.no_grad`` is per thread: the batcher's waveforms carry no
    graph even when the caller's thread records one."""
    with torch.enable_grad():
        w = service.submit(seed=3, nb_vec=1).result(timeout=300)
    assert not w.requires_grad and w.grad_fn is None


def test_http_surface(service, http_server):
    port = http_server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["stage"] == STAGE and health["devices"] == ["cpu"]

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize?seed=5&nb_vec=1", method="POST",
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        body = r.read()
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(body))
    assert sr == service.audio_cfg.sample_rate
    np.testing.assert_array_equal(wav, _wave(service.submit(seed=5, nb_vec=1)))

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["batches"] >= 1

    # error surface: bad args -> 400 JSON, server keeps serving
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize?nb_vec=0", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    ei.value.close()


def test_http_streaming_wav(service, http_server):
    """`?stream=1` returns a chunked WAV (the device-to-host copy a segment
    at a time between socket writes) that decodes to the same samples as
    the buffered route."""
    port = http_server

    def fetch(extra=""):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize?seed=11&nb_vec=1{extra}", method="POST",
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            return r.read(), r.headers

    body_s, hdr_s = fetch("&stream=1")
    assert hdr_s.get("Transfer-Encoding") == "chunked"
    assert hdr_s.get("Content-Length") is None
    body_b, _ = fetch()

    from scipy.io import wavfile

    sr_s, wav_s = wavfile.read(io.BytesIO(body_s))
    sr_b, wav_b = wavfile.read(io.BytesIO(body_b))
    assert sr_s == sr_b == service.audio_cfg.sample_rate
    np.testing.assert_array_equal(wav_s, wav_b)


def test_http_keepalive_post_with_body(service, http_server):
    """POSTs carrying a body over a REUSED HTTP/1.1 connection: the
    handler must drain the unread body, or the next request on the same
    socket is parsed from the leftover body bytes and 400s."""
    conn = http.client.HTTPConnection("127.0.0.1", http_server, timeout=300)
    try:
        for seed in (3, 4):  # two requests, one persistent connection
            conn.request(
                "POST",
                f"/synthesize?seed={seed}&nb_vec=1",
                body=json.dumps({"client_tag": "keepalive-test"}),
                headers={"Content-Type": "application/json"},
            )
            r = conn.getresponse()
            assert r.status == 200
            body = r.read()
            assert body[:4] == b"RIFF"
    finally:
        conn.close()


def test_http_chunked_body_refused_with_411(service, http_server):
    """A Transfer-Encoding: chunked POST has no Content-Length, so its
    framing would survive the body drain and poison a kept-alive
    connection — the handler must refuse it (411) and close."""
    conn = http.client.HTTPConnection("127.0.0.1", http_server, timeout=300)
    try:
        conn.putrequest("POST", "/synthesize?seed=5&nb_vec=1")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        # one chunk + terminator — the exact bytes that would otherwise be
        # parsed as the next request line
        conn.send(b"5\r\nhello\r\n0\r\n\r\n")
        r = conn.getresponse()
        assert r.status == 411
        assert "Content-Length" in json.loads(r.read())["error"]
        # server must close the (unparseable-past-here) connection
        assert r.getheader("Connection") == "close" or r.will_close
    finally:
        conn.close()


def test_cli_serve_on_cpu_answers_a_request(tmp_path):
    """``python -m musicgan_tpu_torch serve`` with the shipped generator on
    the CPU: read the port from its "listening" line, answer one POST with
    a valid WAV, stop on SIGTERM."""
    with subprocess.Popen(
        [sys.executable, "-u", "-m", "musicgan_tpu_torch", "serve", GEN_PT, "--port", "0",
         "--no-warmup", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) as proc:
        try:
            port = None
            for line in proc.stdout:
                m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
                if m:
                    port = int(m.group(1))
                    break
            assert port, "no listening line"
            req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize?seed=3&nb_vec=1",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                body = r.read()
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(body))
    assert sr == 44100 and wav.shape == ((2 * 2 ** 8 - 1) * 256,) and np.isfinite(wav).all()
    assert float(np.abs(wav).max()) > 1e-3


@pytest.fixture(scope="module")
def mesh_service():
    """The service over a mesh of eight CPU devices (conftest gives JAX's
    service eight virtual ones)."""
    svc = SynthesisService(
        _tiny_generator(), max_batch=4, window_ms=500.0, default_stage=STAGE,
        mesh=Mesh(("cpu",) * 8), device="cpu",
    )
    yield svc
    svc.close()


def test_longclip_route_matches_unsharded(monkeypatch, mesh_service):
    """A solo wide request routes through the time-sharded path: its
    signature says so, its samples are ``sharded_synthesize_fn``'s bit for
    bit, and they match JAX's unsharded ``synthesize_fn`` on the same latent
    and weights within JAX's own sharded-vs-unsharded bar
    (``tests/test_serve.py``: 5e-4)."""
    monkeypatch.setattr(generate_mod, "latents", jax_latents)
    nb_vec = 4  # latent width 2*4 = 8 divides the 8-device mesh
    before = dict(mesh_service.stats_snapshot())
    w = mesh_service.submit(seed=21, nb_vec=nb_vec, stage=STAGE).result(timeout=600)
    snap = mesh_service.stats_snapshot()
    assert f"stage{STAGE}/nb_vec{nb_vec}/longclip8" in snap["signatures"]
    assert snap["requests"] - before["requests"] == 1 and snap["batches"] - before["batches"] == 1

    z = jax_latents(CFG, nb_vec, 1, 21, "cpu")
    sharded = join_pieces(sharded_synthesize_fn(Mesh(("cpu",) * 8), CFG, STAGE)(mesh_service.gen, z))
    assert torch.equal(w, sharded)
    ref = np.asarray(jax_synthesize_fn(TINY_MODEL, STAGE)(_jax_params(), z.numpy()))[0]
    assert w.shape == ref.shape
    np.testing.assert_allclose(w.numpy(), ref, atol=5e-4)


def test_longclip_not_used_for_batches(mesh_service):
    """Concurrent wide requests still micro-batch on the batched path (the
    time-sharded one is for solo requests only)."""
    before = list(mesh_service.stats_snapshot()["signatures"])
    futs = [mesh_service.submit(seed=s, nb_vec=4, stage=STAGE) for s in range(3)]
    waves = [_wave(f) for f in futs]
    assert all(np.isfinite(w).all() for w in waves)
    new = [s for s in mesh_service.stats_snapshot()["signatures"] if s not in before]
    assert any("b2" in s or "b4" in s for s in new) or not new
