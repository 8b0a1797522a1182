"""Synthesis serving: a long-running HTTP server over the resident generator.

Counterpart of ``musicgan_tpu/serve.py``:

* **The generator stays resident on its device** for the life of the
  server; each request only ships a seed and fetches a waveform.
* **Micro-batching**: a collector thread gathers concurrent requests of
  one ``(stage, nb_vec)`` signature that arrive within ``window_ms`` and
  runs them as ONE batched synthesis through ``generate.synthesize_fn``,
  padded up to the next power-of-two bucket, so traffic meets a handful of
  batch shapes.  ``conv_impl`` "auto" (the default) resolves once per batch
  shape, at its first dispatch (the warm-up's for the default signature,
  before any request is timed): the measured winner on the card, the
  kernels (K1 and K3, or K4 under ``"pallas_block"``) or the library
  lowering, and the vocoder likewise (K5 or the plain iSTFT).
* stdlib-only HTTP (``ThreadingHTTPServer``).

Endpoints:
  ``POST /synthesize?seed=0&nb_vec=10&stage=7`` -> ``audio/wav`` bytes
    (``nb_vec`` is capped, default 120 ~ 6 min of audio per request;
    ``&stream=1`` sends a chunked body)
  ``GET /healthz`` -> JSON liveness + device
  ``GET /stats``   -> JSON counters (requests, batches, padded slots,
                      signatures, live ``queue_depth``)

A request's latent is ``generate.latents(cfg, nb_vec, 1, seed, device)``:
the draw of ``generate(seed=seed, nb_music=1)``.  The batcher thread does
all the device work; a failure there (a kernel build, a launch, running out
of memory) reaches every waiting request's future, and over HTTP comes back
as a JSON 400.  Futures resolve to rows of the batch's waveforms on the
device; the HTTP threads copy them to the host (the default stream orders
the copy after the synthesis).

**Long clips**: with a device mesh (``mesh``: ``"auto"`` builds one over
every visible card, ``None`` with one card), a solo request of at least
``longclip_min_nb_vec`` vectors whose latent width divides over the mesh
runs TIME-SHARDED across its devices (``parallel/longclip.py``), so that
long clips scale with the cards instead of serializing on one.  Batches
never take that route.  Its future resolves to the waveform on the host.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import generate as generate_mod
from .config import AudioConfig, GenerateConfig, ModelConfig
from .device import resolve_device
from .models import Generator

__all__ = ["SynthesisService", "serve"]


@dataclass
class _Request:
    seed: int
    nb_vec: int
    stage: int
    future: Future = field(default_factory=Future)

    @property
    def signature(self):
        return (self.stage, self.nb_vec)


def _next_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class SynthesisService:
    """Device-resident generator + micro-batching request collector.

    Usable directly (``submit().result()``) or behind the HTTP layer.
    ``gen`` moves to ``device`` (``cuda`` unless the caller passes
    ``"cpu"``); its ``cfg`` is the service's model configuration (the
    blocks' ``conv_impl`` included)."""

    def __init__(
        self,
        gen: Generator,
        audio_cfg: AudioConfig = AudioConfig(),
        max_batch: int = 8,
        window_ms: float = 10.0,
        default_stage: int = 7,
        mesh="auto",
        longclip_min_nb_vec: int = 4,
        max_nb_vec: int = 120,
        device: str | torch.device | None = None,
    ):
        """``mesh``: ``"auto"`` builds a :class:`parallel.Mesh` over every
        visible card where there is more than one (on the CPU, none);
        ``None`` serves on one device; or pass a ``parallel.Mesh``.  A solo
        request whose latent width divides over the mesh runs time-sharded
        across its devices."""
        self.device = resolve_device(device)
        from .parallel import Mesh, make_mesh

        if isinstance(mesh, str) and mesh == "auto":
            mesh = make_mesh() if self.device.type == "cuda" else None
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be None, 'auto' or a parallel.Mesh, got {mesh!r}")
        self.mesh = mesh
        self.longclip_min_nb_vec = longclip_min_nb_vec
        self.gen = gen.to(self.device).eval()  # resident for the server's life
        self.model_cfg = gen.cfg
        self.audio_cfg = audio_cfg
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.default_stage = default_stage
        # Each distinct nb_vec is a batch shape of its own (and its own conv
        # plans); 120 vecs ~ 6 minutes of audio per request — beyond that,
        # clients should chunk.
        self.max_nb_vec = max_nb_vec
        self._fns: dict = {}  # stage -> synthesize fn
        self._longclip_fns: dict = {}  # stage -> time-sharded fn
        self._q: queue.Queue = queue.Queue()
        self._pending: deque = deque()  # deferred other-signature requests
        self._stop = threading.Event()
        # Mutated by the batcher thread, read by HTTP handler threads
        # (/stats): guard with a lock and serve snapshots so a reader never
        # observes a half-updated dict.
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "batched_requests": 0,
            "padded_slots": 0,
            "signatures": [],
        }
        self._worker = threading.Thread(
            target=self._run, name="synthesis-batcher", daemon=True
        )
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(
        self,
        seed: int,
        nb_vec: int = GenerateConfig.nb_vec,
        stage: Optional[int] = None,
    ) -> Future:
        """Enqueue one synthesis; the Future resolves to a float32 ``(T,)``
        waveform on the service's device."""
        stage = self.default_stage if stage is None else stage
        if not 0 <= stage < self.model_cfg.n_stages:
            raise ValueError(f"stage {stage} out of range")
        if nb_vec < 1:
            raise ValueError("nb_vec must be >= 1")
        if nb_vec > self.max_nb_vec:
            raise ValueError(
                f"nb_vec {nb_vec} > max {self.max_nb_vec} (each distinct "
                "nb_vec is a batch shape of its own; request long audio in "
                "chunks)"
            )
        req = _Request(int(seed), int(nb_vec), int(stage))
        self._q.put(req)
        return req.future

    def stats_snapshot(self) -> dict:
        """Consistent copy of the counters (safe from any thread)."""
        with self._stats_lock:
            snap = dict(self.stats)
            snap["signatures"] = list(self.stats["signatures"])
        # Live load signal: requests enqueued but not yet picked up by the
        # batcher (approximate by nature: the batcher drains concurrently).
        snap["queue_depth"] = self._q.qsize() + len(self._pending)
        return snap

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the collector
        self._worker.join(timeout=10)

    def warmup(self, nb_vec: int = GenerateConfig.nb_vec) -> None:
        """Run the batch-1 bucket of the default signature once, so the
        first request does not pay the kernels' build and load."""
        self.submit(seed=0, nb_vec=nb_vec).result()

    # -- batcher ------------------------------------------------------------

    def _collect(self) -> list[_Request]:
        """Pick the oldest waiting request as the batch leader, then drain
        same-signature arrivals for up to ``window_s``.

        Other-signature requests land in ``self._pending`` (batcher-thread
        private), which is always drained BEFORE the queue — so under
        sustained load of one dominant signature, a deferred minority
        request becomes the next leader instead of being re-enqueued behind
        fresh arrivals forever."""
        if self._pending:
            first = self._pending.popleft()
        else:
            first = self._q.get()
            if first is None:
                return []
        batch = [first]
        # Same-signature requests deferred in earlier rounds join first.
        still_pending = deque()
        for r in self._pending:
            if r.signature == first.signature and len(batch) < self.max_batch:
                batch.append(r)
            else:
                still_pending.append(r)
        self._pending = still_pending
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                r = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if r is None:
                break
            if r.signature == first.signature:
                batch.append(r)
            else:
                self._pending.append(r)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._execute(batch)
            except Exception as e:  # surface to all waiters, keep serving
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _use_longclip(self, batch: list[_Request]) -> bool:
        if self.mesh is None or len(batch) != 1:
            return False
        nb_vec = batch[0].nb_vec
        return (
            nb_vec >= self.longclip_min_nb_vec
            and (self.model_cfg.latent_width * nb_vec) % self.mesh.size == 0
        )

    def _execute_longclip(self, req: _Request) -> None:
        """Solo long request: the synthesis sharded along time over the
        mesh (``parallel/longclip.py``), on the request's seeded latent."""
        from .parallel.longclip import join_pieces, sharded_synthesize_fn

        stage = req.stage
        if stage not in self._longclip_fns:
            self._longclip_fns[stage] = sharded_synthesize_fn(self.mesh, self.model_cfg, stage)
        z = generate_mod.latents(self.model_cfg, req.nb_vec, 1, req.seed, self.device)
        wave = join_pieces(self._longclip_fns[stage](self.gen, z))
        sig = f"stage{stage}/nb_vec{req.nb_vec}/longclip{self.mesh.size}"
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["batches"] += 1
            if sig not in self.stats["signatures"]:
                self.stats["signatures"].append(sig)
        req.future.set_result(wave)

    @torch.no_grad()  # no_grad is per thread: this is the batcher's
    def _execute(self, batch: list[_Request]) -> None:
        if self._use_longclip(batch):
            self._execute_longclip(batch[0])
            return
        stage, nb_vec = batch[0].signature
        cfg = self.model_cfg
        bucket = _next_bucket(len(batch), self.max_batch)
        # Per-request latent from its own seed: deterministic, cacheable.
        zs = [generate_mod.latents(cfg, nb_vec, 1, r.seed, self.device)[0] for r in batch]
        zs += [zs[-1]] * (bucket - len(batch))  # pad to the bucket
        z = torch.stack(zs)

        if stage not in self._fns:
            self._fns[stage] = generate_mod.synthesize_fn(cfg, stage)
        # The batch stays on the device; each future resolves to its row,
        # which the HTTP layer copies to the host (whole or by segments).
        waves = self._fns[stage](self.gen, z)

        sig = f"stage{stage}/nb_vec{nb_vec}/b{bucket}"
        with self._stats_lock:
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["batched_requests"] += (
                len(batch) if len(batch) > 1 else 0
            )
            self.stats["padded_slots"] += bucket - len(batch)
            if sig not in self.stats["signatures"]:
                self.stats["signatures"].append(sig)
        for r, w in zip(batch, waves):
            r.future.set_result(w)


def _wav_bytes(wave: np.ndarray, sample_rate: int) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sample_rate, np.asarray(wave, np.float32))
    return buf.getvalue()


def _wav_header(n_samples: int, sample_rate: int) -> bytes:
    """RIFF header for a mono float32 WAV of known length (IEEE-float
    format 3 with the spec-required 'fact' chunk — matching scipy's
    layout), so a streamed body can start before the data is fetched."""
    import struct

    data = n_samples * 4
    return b"".join([
        b"RIFF", struct.pack("<I", 4 + 26 + 12 + 8 + data), b"WAVE",
        b"fmt ", struct.pack(
            "<IHHIIHH", 18, 3, 1, sample_rate, sample_rate * 4, 4, 32
        ), struct.pack("<H", 0),
        b"fact", struct.pack("<II", 4, n_samples),
        b"data", struct.pack("<I", data),
    ])


def _host(wave: torch.Tensor) -> np.ndarray:
    return wave.detach().to("cpu", torch.float32).numpy()


def _device_names(device: torch.device) -> list[str]:
    if device.type == "cuda":
        return [f"{device} {torch.cuda.get_device_name(device)}"]
    return [str(device)]


def _make_handler(service: SynthesisService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer for streaming

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # tell the client too (close_connection alone only stops
                # the server loop; a keep-alive client would wait on the
                # half-open socket)
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "devices": _device_names(service.device),
                    "stage": service.default_stage,
                })
            elif path == "/stats":
                self._json(200, service.stats_snapshot())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            # Drain any request body first: under HTTP/1.1 keep-alive an
            # unread body would be parsed as the NEXT request line on the
            # reused connection, 400-ing every subsequent pooled request.
            # A chunked body has no Content-Length — its framing would
            # survive the drain below and poison the connection the same
            # way, so refuse it (411: length required) and close.
            if self.headers.get("Transfer-Encoding"):
                self.close_connection = True
                self._json(411, {
                    "error": "chunked request bodies unsupported; "
                             "send Content-Length (bodies are ignored — "
                             "use query parameters)"
                })
                return
            blen = int(self.headers.get("Content-Length") or 0)
            while blen > 0:
                got = self.rfile.read(min(blen, 1 << 16))
                if not got:  # EOF before Content-Length bytes (lying or
                    break    # disconnected client) — never busy-loop on it
                blen -= len(got)
            url = urlparse(self.path)
            if url.path != "/synthesize":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            q = parse_qs(url.query)

            def arg(name, default):
                return int(q[name][0]) if name in q else default

            try:
                fut = service.submit(
                    seed=arg("seed", int(time.time_ns() % 2**31)),
                    nb_vec=arg("nb_vec", GenerateConfig.nb_vec),
                    stage=arg("stage", None) if "stage" in q else None,
                )
                wave = fut.result(timeout=600)
                if arg("stream", 0):
                    # the first-segment fetch happens before any headers
                    # are sent, so device errors still yield a JSON 400
                    self._stream_wav(wave)
                    return
                # the copy to the host is where an asynchronous device
                # error surfaces: keep it inside the guard so clients get
                # the JSON error, not a reset socket
                body = _wav_bytes(_host(wave), service.audio_cfg.sample_rate)
            except Exception as e:
                self._json(400, {"error": repr(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_wav(self, wave: torch.Tensor) -> None:
            """Chunked WAV response (`POST /synthesize?...&stream=1`): the
            waveform stays on the device until here and is copied to the
            host a segment at a time between socket writes."""
            n = int(wave.shape[0])
            seg = 262_144  # 1 MiB of float32 per segment
            # Fetch the first segment BEFORE committing to a 200: device
            # errors propagate to do_POST's guard as a JSON 400.
            first = _host(wave[:seg])
            self.send_response(200)

            def chunk(data: bytes) -> None:
                self.wfile.write(b"%X\r\n" % len(data))
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            # EVERY write after send_response sits inside the abort
            # guard: once the 200 status line is out, a socket failure
            # must drop the connection — letting it propagate would land
            # in do_POST's JSON-400 path, which would write a second
            # status line onto the committed response.
            try:
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                chunk(_wav_header(n, service.audio_cfg.sample_rate))
                chunk(first.tobytes())
                for a in range(seg, n, seg):
                    chunk(_host(wave[a : a + seg]).tobytes())
                self.wfile.write(b"0\r\n\r\n")
            except Exception as e:  # mid-stream device/socket failure:
                # headers are out — a JSON error would corrupt the chunked
                # body.  Drop the connection; the missing terminating
                # chunk tells the client the body is truncated.
                print(f"[serve] stream aborted: {e!r}", flush=True)
                self.close_connection = True

    return Handler


def serve(
    gen_ckpt: str,
    host: str = "127.0.0.1",
    port: int = 8765,
    rand_channels: int = ModelConfig.rand_channels,
    max_batch: int = 8,
    window_ms: float = 10.0,
    stage: int = 7,
    warmup: bool = True,
    model_cfg: Optional[ModelConfig] = None,
    device: str | torch.device | None = None,
) -> None:
    """CLI workflow: load the checkpoint once, serve synthesis until the
    process is stopped.  ``device``: ``cuda`` unless the caller passes
    ``"cpu"``."""
    import dataclasses

    device = resolve_device(device)
    if model_cfg is None:
        model_cfg = (
            ModelConfig()
            if rand_channels == ModelConfig.rand_channels
            else dataclasses.replace(ModelConfig(), rand_channels=rand_channels)
        )
    gen = generate_mod.load_generator_params(gen_ckpt, model_cfg, device)
    service = SynthesisService(
        gen, max_batch=max_batch, window_ms=window_ms,
        default_stage=stage, device=device,
    )
    if warmup:
        t0 = time.perf_counter()
        service.warmup()
        print(f"[serve] warmup: {time.perf_counter() - t0:.1f}s", flush=True)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    print(f"[serve] listening on http://{host}:{server.server_address[1]} "
          f"(stage {stage}, max_batch {max_batch}, window {window_ms}ms, "
          f"{_device_names(device)[0]})", flush=True)
    try:
        server.serve_forever()
    finally:
        service.close()
