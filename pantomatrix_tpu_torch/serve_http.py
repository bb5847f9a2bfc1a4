"""HTTP motion-serving daemon of the port (counterpart of
``pantomatrix_tpu/serve_http.py``): many concurrent audio streams on one card.

A stdlib HTTP server where each client owns a session, POSTs 16 kHz audio as it arrives
and reads decoded motion (SMPL-X axis angles, FLAME expressions, global translation)
back as each 64-frame window completes. One pump thread batches every ready session
into one window step and one chunk decode per wave (``serve.StreamingPool``; on the card
both replay CUDA graphs).

Wire protocol (JSON and npz over HTTP/1.1; stdlib only on both ends), the JAX daemon's.
Session ids are unguessable opaque tokens (no authentication beyond them):

    POST   /v1/sessions                  {"speaker_id": 0}
                                         -> {"session_id": "f3a9c1..."}
    POST   /v1/sessions/<id>/audio       body dispatched on Content-Type:
                                           audio/wav|audio/x-wav  WAV container
                                           audio/mpeg|audio/mp3   MP3
                                           application/octet-stream (or absent)
                                             raw float32 LE PCM @ 16 kHz, after
                                             an unambiguous container-magic
                                             sniff (RIFF/WAVE, ID3)
                                         -> {"buffered_samples": n}
    GET    /v1/sessions/<id>/motion?timeout_ms=500
                                         -> npz {poses (t,165), expressions
                                            (t,100), trans (t,3)}; t == 0 when
                                            nothing new before the deadline
    POST   /v1/sessions/<id>/flush       -> npz (remainder window + pending)
    DELETE /v1/sessions/<id>             -> 204
    GET    /v1/health                    -> {"sessions", "batch", "device",
                                             "max_sessions", "evicted_total"}

Robustness:
- ``max_sessions`` caps the open sessions; opens beyond it get 503;
- a session that neither feeds nor reads for ``idle_timeout_s`` is evicted and freed;
- ingest never waits on device work: feeds, opens, closes and reads touch only host
  staging state under ``_state``; the pump thread folds staged work into the pool
  between waves (``_drain_staged``);
- motion drained for a client whose connection died mid-response is re-queued, not lost
  (``requeue``).

All device work, CUDA graph captures included, runs under ``_device_lock``: a capture
must see no launch from another thread, and ``strict_fp32`` sets process-wide flags.
Numerics are ``StreamingPool``'s.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .serve import GenerationResult, StreamingPool

_EMPTY = GenerationResult(
    motion_axis_angle=np.zeros((0, 165), np.float32),
    expressions=np.zeros((0, 100), np.float32),
    trans=np.zeros((0, 3), np.float32),
)


class ServerFull(RuntimeError):
    """Raised when opening a session would exceed ``max_sessions`` (HTTP 503)."""


class UnsupportedMediaType(ValueError):
    """Raised for an audio body whose Content-Type is not servable (HTTP 415)."""


def _concat_results(results: List[GenerationResult]) -> GenerationResult:
    if not results:
        return _EMPTY
    return GenerationResult(
        motion_axis_angle=np.concatenate([r.motion_axis_angle for r in results], 0),
        expressions=np.concatenate([r.expressions for r in results], 0),
        trans=np.concatenate([r.trans for r in results], 0),
    )


def result_to_npz_bytes(res: GenerationResult) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, poses=res.motion_axis_angle, expressions=res.expressions,
             trans=res.trans)
    return buf.getvalue()


def npz_bytes_to_result(data: bytes) -> GenerationResult:
    with np.load(io.BytesIO(data)) as z:
        return GenerationResult(motion_axis_angle=z["poses"],
                                expressions=z["expressions"], trans=z["trans"])


_WAV_TYPES = {"audio/wav", "audio/x-wav", "audio/wave", "audio/vnd.wave"}
_MP3_TYPES = {"audio/mpeg", "audio/mp3"}
_RAW_TYPES = {"", "application/octet-stream", "audio/pcm"}


def _decode_container(body: bytes) -> np.ndarray:
    from .data.audio import load_audio

    # the port's decoders read files
    fd, path = tempfile.mkstemp(suffix=".wav")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body)
        return load_audio(path, 16000)
    finally:
        os.unlink(path)


def _decode_audio_body(body: bytes, content_type: Optional[str] = None) -> np.ndarray:
    """Audio-body dispatch, keyed on Content-Type first.

    An explicit container type (audio/wav, audio/mpeg) always decodes as that
    container; octet-stream/absent bodies are raw float32 PCM after an
    UNAMBIGUOUS container-magic sniff (RIFF..WAVE, ID3 — 8- and 3-byte magics).
    MP3 frame-sync sniffing (0xFF + 3 bits) is deliberately NOT applied to
    octet-stream bodies: ~1/2048 of legitimate random float32 streams start
    with a frame-sync pattern and would be silently misrouted to the MP3
    decoder — clients sending headerless MP3 frames must say audio/mpeg.
    """
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct in _WAV_TYPES or ct in _MP3_TYPES:
        return _decode_container(body)
    if ct not in _RAW_TYPES:
        raise UnsupportedMediaType(
            f"unsupported audio Content-Type {ct!r} (use audio/wav, audio/mpeg, "
            "or application/octet-stream for raw float32 PCM)"
        )
    is_wav = body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    is_id3 = body[:3] == b"ID3"
    if is_wav or is_id3:
        return _decode_container(body)
    if len(body) % 4:
        raise ValueError(
            f"audio body is {len(body)} bytes — not float32 PCM and not a "
            "recognized WAV/MP3 container"
        )
    return np.frombuffer(body, np.float32)


@dataclass
class _SessionState:
    """Host-side per-session bookkeeping (guarded by ``MotionServer._state``).

    The pool's own session object is created lazily by the pump thread
    (``sid`` is None until then), so opening never touches the device path.
    """

    speaker_id: int
    sid: Optional[int] = None                 # pool session id once drained
    pending_audio: List[np.ndarray] = field(default_factory=list)
    pending_samples: int = 0
    pool_buffered: int = 0                    # pool-side buffer size at last drain
    queue: List[GenerationResult] = field(default_factory=list)
    last_active: float = field(default_factory=time.monotonic)
    closing: bool = False


class MotionServer:
    """Threaded HTTP daemon over a :class:`StreamingPool`.

    Thread model: two locks.

    - ``_state`` (with the ``_emitted`` condition): host-side staging — audio
      buffers, output queues, session lifecycle flags. Handler threads for
      feed/open/read/close take ONLY this lock, so ingest never waits on a
      running device wave.
    - ``_device_lock``: serializes every entry into the pool's window step and
      decode (graph captures and replays included). The pump thread holds it for
      batched waves; a ``flush`` handler thread holds it for that session's
      remainder window. Device work is serialized by this lock, not confined to
      one thread.

    Lock order is always device -> state; no path takes state then device.
    """

    def __init__(self, model, vq_model, batch: int = 8,
                 host: str = "127.0.0.1", port: int = 0,
                 max_sessions: int = 64, idle_timeout_s: float = 600.0):
        self.pool = StreamingPool(model, vq_model, batch=batch)
        self.batch = batch
        self.max_sessions = max_sessions
        self.idle_timeout_s = idle_timeout_s
        self.evicted_total = 0
        self._device_lock = threading.Lock()
        self._state = threading.Lock()
        self._emitted = threading.Condition(self._state)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._sessions: Dict[str, _SessionState] = {}
        self._sid2tok: Dict[int, str] = {}
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.motion = self  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MotionServer":
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
            threading.Thread(target=self._pump_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    def _publish(self, waves: List[tuple]) -> None:
        """Route pool (sid, result) emissions onto session queues. Call with
        ``_device_lock`` held so emissions from overlapping pump/flush entries
        keep device order."""
        with self._emitted:
            for sid, res in waves:
                tok = self._sid2tok.get(sid)
                s = self._sessions.get(tok) if tok is not None else None
                if s is not None and not s.closing:
                    s.queue.append(res)
            self._emitted.notify_all()

    def _drain_staged(self) -> None:
        """Fold staged host-side work into the pool: evictions, closes, lazy
        opens, buffered audio. Call with ``_device_lock`` held; takes
        ``_state`` briefly (no device dispatch happens here beyond the pool's
        per-session host bookkeeping)."""
        now = time.monotonic()
        with self._emitted:
            for token, s in list(self._sessions.items()):
                if (not s.closing and self.idle_timeout_s
                        and now - s.last_active > self.idle_timeout_s):
                    s.closing = True
                    self.evicted_total += 1
                if s.closing:
                    if s.sid is not None:
                        self.pool.close(s.sid)
                        del self._sid2tok[s.sid]
                    del self._sessions[token]
                    continue
                if s.sid is None:
                    s.sid = self.pool.open(speaker_id=s.speaker_id)
                    self._sid2tok[s.sid] = token
                if s.pending_audio:
                    for chunk in s.pending_audio:
                        self.pool.feed(s.sid, chunk)
                    s.pending_audio = []
                    s.pending_samples = 0
                if s.sid is not None:
                    s.pool_buffered = int(self.pool.session(s.sid)._audio.size)
            # wake readers blocked on sessions that just got evicted/closed
            self._emitted.notify_all()

    def _pump_once(self) -> bool:
        with self._device_lock:
            self._drain_staged()
            if not self.pool.ready():
                return False
            self._publish(self.pool.pump())
        return True

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            if not self._pump_once():
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    # -- session ops (called from handler threads) ---------------------------
    def open_session(self, speaker_id: int = 0) -> str:
        with self._state:
            live = sum(1 for s in self._sessions.values() if not s.closing)
            if live >= self.max_sessions:
                raise ServerFull(
                    f"session limit reached ({live}/{self.max_sessions})"
                )
            token = uuid.uuid4().hex
            self._sessions[token] = _SessionState(speaker_id=int(speaker_id))
        self._wake.set()
        return token

    def _session(self, token: str) -> _SessionState:
        """Look up a live session (caller holds ``_state``)."""
        s = self._sessions.get(token)
        if s is None or s.closing:
            raise KeyError(token)
        return s

    def feed(self, token: str, audio: np.ndarray) -> int:
        audio = np.asarray(audio, np.float32).ravel()
        with self._state:
            s = self._session(token)
            s.pending_audio.append(audio)
            s.pending_samples += int(audio.size)
            s.last_active = time.monotonic()
            buffered = s.pool_buffered + s.pending_samples
        self._wake.set()
        return buffered

    def read_motion_chunks(self, token: str,
                           timeout_s: float = 0.0) -> List[GenerationResult]:
        """Drain the session's emitted windows (blocking up to ``timeout_s``).
        Returns the raw chunk list so a failed response write can ``requeue``
        exactly what was drained."""
        deadline = time.monotonic() + timeout_s
        with self._emitted:
            s = self._session(token)
            s.last_active = time.monotonic()
            while not s.queue:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._emitted.wait(timeout=remaining):
                    break
                s = self._session(token)  # may have been evicted while waiting
            results, s.queue = s.queue, []
            s.last_active = time.monotonic()
        return results

    def read_motion(self, token: str, timeout_s: float = 0.0) -> GenerationResult:
        return _concat_results(self.read_motion_chunks(token, timeout_s))

    def requeue(self, token: str, results: List[GenerationResult]) -> None:
        """Put drained results back at the FRONT of the queue (the client's
        connection died before the response was written — redeliver on its next
        read instead of losing the frames)."""
        if not results:
            return
        with self._emitted:
            s = self._sessions.get(token)
            if s is not None and not s.closing:
                s.queue[:0] = results
                self._emitted.notify_all()

    def flush(self, token: str) -> GenerationResult:
        with self._state:
            self._session(token).last_active = time.monotonic()
        with self._device_lock:
            self._drain_staged()
            with self._state:
                sid = self._session(token).sid
            # drain any complete windows first so the remainder really is last
            self._publish(self.pool.pump())
            remainder = self.pool.flush(sid)
            with self._state:
                s = self._sessions.get(token)
                pending: List[GenerationResult] = []
                if s is not None:
                    pending, s.queue = s.queue, []
                    s.last_active = time.monotonic()
            pending.append(remainder)
        return _concat_results(pending)

    def close_session(self, token: str) -> None:
        """Mark closed; the pump thread frees the pool slot at the next drain."""
        with self._emitted:
            self._session(token).closing = True
            self._emitted.notify_all()
        self._wake.set()

    def health(self) -> dict:
        with self._state:
            n = sum(1 for s in self._sessions.values() if not s.closing)
        device = next(self.pool.model.parameters()).device
        return {"sessions": n, "batch": self.batch,
                "max_sessions": self.max_sessions,
                "evicted_total": self.evicted_total,
                "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else str(device))}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------
    @property
    def motion(self) -> MotionServer:
        return self.server.motion  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("PANTO_SERVE_VERBOSE"):
            super().log_message(fmt, *args)

    def _json(self, obj: dict, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _npz(self, res: GenerationResult) -> None:
        data = result_to_npz_bytes(res)
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Frames", str(res.motion_axis_angle.shape[0]))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def _route(self) -> Tuple[str, Optional[str], Optional[str], dict]:
        path, _, query = self.path.partition("?")
        qs = dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)
        parts = [p for p in path.split("/") if p]
        if parts[:2] == ["v1", "sessions"] and len(parts) >= 3:
            return ("session", parts[2], parts[3] if len(parts) > 3 else None, qs)
        return ("/".join(parts), None, None, qs)

    def _error(self, e: Exception) -> None:
        """Uniform error mapping for every verb (one client's malformed request
        must never drop the connection without an HTTP response)."""
        if isinstance(e, KeyError):
            self._json({"error": "no such session"}, 404)
        elif isinstance(e, ServerFull):
            self._json({"error": str(e)}, 503)
        elif isinstance(e, UnsupportedMediaType):
            self._json({"error": str(e)}, 415)
        elif isinstance(e, ValueError):
            self._json({"error": str(e)}, 400)
        else:  # surface errors to the client, not the console
            self._json({"error": str(e)}, 500)

    # -- verbs ---------------------------------------------------------------
    def do_GET(self):
        try:
            kind, sid, sub, qs = self._route()
            if kind == "v1/health":
                return self._json(self.motion.health())
            if kind == "session" and sub == "motion":
                timeout_s = float(qs.get("timeout_ms", 0)) / 1e3
                chunks = self.motion.read_motion_chunks(sid, timeout_s)
                try:
                    return self._npz(_concat_results(chunks))
                except (BrokenPipeError, ConnectionError, OSError):
                    # client gone mid-response: redeliver next time, stay quiet
                    self.motion.requeue(sid, chunks)
                    self.close_connection = True
                    return
            self._json({"error": "not found"}, 404)
        except Exception as e:
            self._error(e)

    def do_POST(self):
        try:
            kind, sid, sub, _ = self._route()
            body = self._body()
            if kind == "v1/sessions":
                spec = json.loads(body) if body else {}
                token = self.motion.open_session(int(spec.get("speaker_id", 0)))
                return self._json({"session_id": token}, 201)
            if kind == "session" and sub == "audio":
                audio = _decode_audio_body(body, self.headers.get("Content-Type"))
                buffered = self.motion.feed(sid, audio)
                return self._json({"buffered_samples": buffered})
            if kind == "session" and sub == "flush":
                res = self.motion.flush(sid)
                try:
                    return self._npz(res)
                except (BrokenPipeError, ConnectionError, OSError):
                    self.motion.requeue(sid, [res])
                    self.close_connection = True
                    return
            self._json({"error": "not found"}, 404)
        except Exception as e:
            self._error(e)

    def do_DELETE(self):
        try:
            kind, sid, sub, _ = self._route()
            if kind == "session" and sub is None:
                self.motion.close_session(sid)
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self._json({"error": "not found"}, 404)
        except Exception as e:
            self._error(e)


class MotionClient:
    """Stdlib HTTP client for :class:`MotionServer` (one connection per call —
    safe to use from multiple threads). Session ids are opaque string tokens."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.host, self.port, self.timeout = host, port, timeout

    def _request(self, method: str, path: str, body: bytes = b"",
                 content_type: str = "application/octet-stream"):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, path, body=body or None,
                         headers={"Content-Type": content_type} if body else {})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                raise RuntimeError(f"{method} {path} -> {resp.status}: "
                                   f"{data[:200]!r}")
            return data
        finally:
            conn.close()

    def open_session(self, speaker_id: int = 0) -> str:
        data = self._request("POST", "/v1/sessions",
                             json.dumps({"speaker_id": speaker_id}).encode(),
                             "application/json")
        return json.loads(data)["session_id"]

    def send_audio(self, sid, audio: np.ndarray) -> int:
        body = np.ascontiguousarray(audio, np.float32).tobytes()
        data = self._request("POST", f"/v1/sessions/{sid}/audio", body)
        return json.loads(data)["buffered_samples"]

    def send_audio_file(self, sid, path: str) -> int:
        ext = os.path.splitext(path)[1].lower()
        ct = {".wav": "audio/wav", ".mp3": "audio/mpeg"}.get(
            ext, "application/octet-stream")
        with open(path, "rb") as f:
            data = self._request("POST", f"/v1/sessions/{sid}/audio",
                                 f.read(), ct)
        return json.loads(data)["buffered_samples"]

    def read_motion(self, sid, timeout_ms: int = 0) -> GenerationResult:
        data = self._request(
            "GET", f"/v1/sessions/{sid}/motion?timeout_ms={timeout_ms}")
        return npz_bytes_to_result(data)

    def flush(self, sid) -> GenerationResult:
        return npz_bytes_to_result(
            self._request("POST", f"/v1/sessions/{sid}/flush"))

    def close_session(self, sid) -> None:
        self._request("DELETE", f"/v1/sessions/{sid}")

    def health(self) -> dict:
        return json.loads(self._request("GET", "/v1/health"))


__all__ = ["MotionClient", "MotionServer", "ServerFull", "UnsupportedMediaType",
           "npz_bytes_to_result", "result_to_npz_bytes"]
