"""The port's HTTP daemon (pantomatrix_tpu_torch.serve_http) on the CPU: the daemon adds
nothing to the port's in-process StreamingPool (same frames out, batched across
concurrent clients), keeps the JAX daemon's wire protocol and robustness behaviour, and
emits the JAX daemon's frames for the same audio and weights.

The tiny config and the weights of tests/test_torch_serve.py (make_stacks: one set held
by both packages). Decoded outputs are held to 1e-5 and rotations to 2e-3, as there.
"""
import time
import wave as wave_mod

import numpy as np
import pytest

from pantomatrix_tpu import serve_http as jserve_http
from pantomatrix_tpu_torch import serve, serve_http
from pantomatrix_tpu_torch.cli import serve as serve_cli
from pantomatrix_tpu_torch.serve_http import MotionClient, MotionServer
from test_torch_serve import ROT_ATOL, make_stacks

ATOL = 1e-5
N_23 = int(np.ceil(23 * 16000 / 30))  # 23 offline frames: 3 windows of 6 + a 5-frame flush


@pytest.fixture(scope="module")
def served_stack():
    jmodel, jvq_model, model, vq = make_stacks()
    server = MotionServer(model, vq, batch=3).start()
    yield jmodel, jvq_model, model, vq, server
    server.stop()


def _read_until(client, sid, n_frames, deadline_s=120.0):
    chunks, got = [], 0
    deadline = time.monotonic() + deadline_s
    while got < n_frames:
        assert time.monotonic() < deadline, f"{got}/{n_frames} frames before the deadline"
        res = client.read_motion(sid, timeout_ms=1000)
        if res.motion_axis_angle.shape[0]:
            chunks.append(res)
            got += res.motion_axis_angle.shape[0]
    return chunks


def _cat(results, field):
    return np.concatenate([np.asarray(getattr(r, field)) for r in results], axis=0)


def _two_clients(server, waves, flush=True):
    """Two sessions (speakers 0 and 1): A's audio in five dribbles, B's in one burst;
    read the 18 frames of the full windows each, flush (unless not asked), close.
    Returns each session's chunks."""
    client = MotionClient(server.host, server.port)
    sids = [client.open_session(speaker_id=i) for i in range(2)]
    assert client.health()["sessions"] == 2
    for chunk in np.array_split(waves[0], 5):
        client.send_audio(sids[0], chunk)
    client.send_audio(sids[1], waves[1])
    got = [_read_until(client, sid, 18) for sid in sids]
    for sid, chunks in zip(sids, got):
        if flush:
            chunks.append(client.flush(sid))
        client.close_session(sid)
    assert client.health()["sessions"] == 0
    return got


def _waves(seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-0.5, 0.5, N_23).astype(np.float32) for _ in range(2)]


def test_daemon_matches_in_process_pool_two_clients(served_stack):
    *_, model, vq, server = served_stack
    waves = _waves(3)
    got = _two_clients(server, waves)
    pool = serve.StreamingPool(model, vq, batch=3)
    for spk, (w, chunks) in enumerate(zip(waves, got)):
        sid = pool.open(speaker_id=spk)
        pool.feed(sid, w)
        ref = [r for _, r in pool.pump()] + [pool.flush(sid)]
        assert _cat(chunks, "motion_axis_angle").shape[0] == 23
        for field, atol in (("motion_axis_angle", ROT_ATOL), ("expressions", ATOL),
                            ("trans", ATOL)):
            np.testing.assert_allclose(_cat(chunks, field), _cat(ref, field), rtol=0,
                                       atol=atol, err_msg=f"speaker {spk}: {field}")


def test_daemon_frames_match_the_jax_daemon(served_stack):
    """The same audio through the JAX daemon: the same poses and expressions of the full
    windows. (The translation of the JAX pool's second session starts from the first's
    position when both share a wave, tests/test_torch_serve.py, so it is held against
    the port's own pool above, as is the flush.)"""
    jmodel, jvq_model, _, _, server = served_stack
    waves = _waves(4)
    got = _two_clients(server, waves, flush=False)
    jserver = jserve_http.MotionServer(jmodel, jvq_model, batch=3).start()
    try:
        want = _two_clients(jserver, waves, flush=False)
    finally:
        jserver.stop()
    for g, w in zip(got, want):
        np.testing.assert_allclose(_cat(g, "motion_axis_angle"), _cat(w, "motion_axis_angle"),
                                   rtol=0, atol=ROT_ATOL)
        np.testing.assert_allclose(_cat(g, "expressions"), _cat(w, "expressions"), rtol=0,
                                   atol=ATOL)


def test_daemon_accepts_wav_container_body(served_stack, tmp_path):
    *_, server = served_stack
    client = MotionClient(server.host, server.port)
    n = 4000
    pcm16 = (np.random.RandomState(7).uniform(-0.5, 0.5, n) * 32767).astype(np.int16)
    path = tmp_path / "clip.wav"
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm16.tobytes())
    sid = client.open_session()
    assert client.send_audio_file(sid, str(path)) == n  # decoded, not read as raw f32
    client.close_session(sid)


def test_daemon_unknown_session_is_a_client_error(served_stack):
    *_, server = served_stack
    client = MotionClient(server.host, server.port)
    with pytest.raises(RuntimeError, match="404"):
        client.read_motion(10**9)
    with pytest.raises(RuntimeError, match="404"):
        client.send_audio(10**9, np.zeros(4, np.float32))


def test_raw_pcm_framesync_prefix_not_misrouted_to_mp3(served_stack):
    *_, server = served_stack
    client = MotionClient(server.host, server.port)
    audio = np.zeros(64, np.float32)
    audio[0] = np.frombuffer(b"\xff\xfb\x90\x00", np.float32)[0]  # an MPEG frame sync
    sid = client.open_session()
    assert client.send_audio(sid, audio) == 64
    client.close_session(sid)


def test_malformed_requests_get_http_status_not_dropped_connections(served_stack):
    *_, server = served_stack
    client = MotionClient(server.host, server.port)
    with pytest.raises(RuntimeError, match="404"):
        client.close_session("definitely-not-a-session")
    sid = client.open_session()
    with pytest.raises(RuntimeError, match="400"):
        client._request("GET", f"/v1/sessions/{sid}/motion?timeout_ms=abc")
    with pytest.raises(RuntimeError, match="415"):
        client._request("POST", f"/v1/sessions/{sid}/audio", b"\x00" * 16, "video/mp4")
    with pytest.raises(RuntimeError, match="400"):
        client._request("POST", f"/v1/sessions/{sid}/audio", b"\x00" * 7)
    client.close_session(sid)


def test_session_ids_are_unguessable_tokens(served_stack):
    *_, server = served_stack
    client = MotionClient(server.host, server.port)
    sid = client.open_session()
    assert isinstance(sid, str) and len(sid) >= 32
    int(sid, 16)
    client.close_session(sid)


def test_feed_and_reads_do_not_block_on_device_lock(served_stack):
    *_, server = served_stack
    client = MotionClient(server.host, server.port)
    with server._device_lock:  # as during a long pump wave
        t0 = time.monotonic()
        sid = client.open_session()
        assert client.send_audio(sid, np.zeros(128, np.float32)) == 128
        assert client.read_motion(sid, timeout_ms=0).motion_axis_angle.shape[0] == 0
        assert time.monotonic() - t0 < 2.0
    client.close_session(sid)


def test_requeue_redelivers_frames_after_failed_response_write(served_stack):
    *_, server = served_stack
    tok = server.open_session()
    server.feed(tok, np.random.RandomState(5).uniform(-0.5, 0.5, 6000).astype(np.float32))
    chunks = server.read_motion_chunks(tok, timeout_s=60.0)
    assert sum(c.motion_axis_angle.shape[0] for c in chunks) == 6
    server.requeue(tok, chunks)  # what the handler does when its write fails
    again = server.read_motion(tok, timeout_s=0.0)
    np.testing.assert_array_equal(again.motion_axis_angle, _cat(chunks, "motion_axis_angle"))
    server.close_session(tok)


def test_session_cap_and_idle_eviction(served_stack):
    *_, model, vq, _ = served_stack
    server = MotionServer(model, vq, batch=2, max_sessions=2, idle_timeout_s=0.3).start()
    try:
        client = MotionClient(server.host, server.port)
        a = client.open_session()
        b = client.open_session()
        with pytest.raises(RuntimeError, match="503"):
            client.open_session()
        client.send_audio(a, np.zeros(256, np.float32))
        deadline = time.monotonic() + 30
        while client.health()["sessions"] and time.monotonic() < deadline:
            time.sleep(0.05)
        h = client.health()
        assert h["sessions"] == 0 and h["evicted_total"] >= 2
        with pytest.raises(RuntimeError, match="404"):
            client.read_motion(a)
        with pytest.raises(RuntimeError, match="404"):
            client.send_audio(b, np.zeros(4, np.float32))
        client.close_session(client.open_session())  # the capacity is free again
    finally:
        server.stop()


def test_health_names_the_torch_device(served_stack):
    *_, server = served_stack
    h = MotionClient(server.host, server.port).health()
    assert h["device"] == "cpu" and h["batch"] == 3 and h["max_sessions"] == 64


def test_npz_round_trip():
    rng = np.random.RandomState(0)
    res = serve.GenerationResult(rng.rand(5, 165).astype(np.float32),
                                 rng.rand(5, 100).astype(np.float32),
                                 rng.rand(5, 3).astype(np.float32))
    back = serve_http.npz_bytes_to_result(serve_http.result_to_npz_bytes(res))
    for f in ("motion_axis_angle", "expressions", "trans"):
        np.testing.assert_array_equal(getattr(back, f), getattr(res, f))


def test_serve_cli_defaults_to_the_card():
    args = serve_cli.build_parser().parse_args([])
    assert (args.device, args.host, args.port, args.batch, args.max_sessions) == \
        ("cuda", "127.0.0.1", 8799, 8, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--random_init"])


def test_concurrent_clients_each_get_their_whole_stream(served_stack):
    """Stress: more client threads than the pool's batch, a short switch interval, every
    session fed in dribbles. Each must receive exactly its 23 frames, each chunk's
    translation continuing from its own previous chunk (x and z)."""
    import sys
    import threading

    *_, server = served_stack
    n_clients = 6
    results, errors = [None] * n_clients, []

    def run(i):
        try:
            client = MotionClient(server.host, server.port)
            sid = client.open_session()
            wave = np.random.RandomState(100 + i).uniform(-0.5, 0.5, N_23).astype(np.float32)
            for chunk in np.array_split(wave, 7):
                client.send_audio(sid, chunk)
            chunks = _read_until(client, sid, 18)
            chunks.append(client.flush(sid))
            client.close_session(sid)
            results[i] = chunks
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    for chunks in results:
        assert _cat(chunks, "motion_axis_angle").shape[0] == 23
        parts = [c for c in chunks if c.trans.shape[0]]
        for a, b in zip(parts, parts[1:]):
            np.testing.assert_array_equal(b.trans[0, [0, 2]], a.trans[-1, [0, 2]])
