"""The port's visualization pieces (pantomatrix_tpu_torch/native, viz/{draw,jpeg,avi},
viz/render2d's projection and drawing, viz/mesh_video's FK) against the JAX package and
cv2 on the CPU.

Inputs are made from numpy seeds. Synthetic SMPL-X archives carry faces between
neighbouring vertices of a small closed surface (a UV ellipsoid). Bounds: the rasterizer's
frames byte-equal to the JAX build's; projection 1e-4 px; FK 1e-5; drawing: cv2's integer
rasterization is reproduced, so frames are held equal to cv2's (the JAX ``draw_frame``)
and each primitive to cv2's own call, clipping included; JPEG: the DQT and DHT segments
equal cv2's at quality 90, cv2 decodes the port's files, PSNR >= 35 dB on mesh and
skeleton frames and within 1 dB of cv2's encode; AVI: cv2 reads the port's file as the
JAX one, the audio chunks are byte-equal.
"""
import struct

import cv2
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import smplx as jsmplx
from pantomatrix_tpu.native import render_mesh_frames as jax_render_mesh_frames
from pantomatrix_tpu.viz import avi as javi
from pantomatrix_tpu.viz import mesh_video as jmesh
from pantomatrix_tpu.viz import render2d as jrender
from pantomatrix_tpu_torch import native
from pantomatrix_tpu_torch.core import smplx
from pantomatrix_tpu_torch.viz import avi, draw, jpeg, mesh_video, render2d

torch.set_num_threads(2)


# -- synthetic data ---------------------------------------------------------------------

def ellipsoid_mesh(rings=6, segs=8):
    """A closed UV ellipsoid, body-sized: (rings * segs + 2, 3) vertices, 2 * rings *
    segs faces between neighbouring vertices."""
    th = np.pi * (np.arange(rings) + 1) / (rings + 1)
    ph = 2 * np.pi * np.arange(segs) / segs
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph), np.cos(th)[:, None] * np.ones(segs),
                     np.sin(th)[:, None] * np.sin(ph)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    verts = verts * [0.25, 0.85, 0.15] + [0.0, 0.9, 0.0]
    at = lambda r, c: 1 + r * segs + c % segs
    south = rings * segs + 1
    faces = [f for c in range(segs)
             for f in ((0, at(0, c + 1), at(0, c)), (south, at(rings - 1, c), at(rings - 1, c + 1)))]
    faces += [f for r in range(rings - 1) for c in range(segs)
              for f in ((at(r, c), at(r, c + 1), at(r + 1, c)),
                        (at(r, c + 1), at(r + 1, c + 1), at(r + 1, c)))]
    return verts, np.asarray(faces, np.int64)


def write_surface_archive(path, rings=6, segs=8, seed=0):
    """A synthetic SMPLX_NEUTRAL_2020.npz with the real archive's keys over an
    ellipsoid's surface (V = rings * segs + 2) and a 55-joint chain whose joints sit on
    spread-out vertices, so that the skeleton spans the body as a real one does."""
    rng = np.random.RandomState(seed)
    verts, faces = ellipsoid_mesh(rings, segs)
    v = len(verts)
    jreg = np.zeros((55, v))
    jreg[np.arange(55), (np.arange(55) * 7) % v] = 1.0
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = np.concatenate([[2**32 - 1], np.arange(54)])
    bary = rng.uniform(0.1, 1.0, (51, 3))
    np.savez(path, v_template=verts, shapedirs=rng.normal(0, 0.01, (v, 3, 400)),
             posedirs=rng.normal(0, 0.01, (v, 3, 486)),
             J_regressor=jreg, kintree_table=kintree,
             weights=np.abs(rng.normal(0, 1, (v, 55))) / 55,
             hands_meanl=rng.normal(0, 0.1, 45), hands_meanr=rng.normal(0, 0.1, 45), f=faces,
             lmk_faces_idx=rng.randint(0, len(faces), 51).astype(np.int64),
             lmk_bary_coords=bary / bary.sum(1, keepdims=True))
    return str(path)


def motion(n, seed=1, spread=0.3):
    rng = np.random.RandomState(seed)
    return {"betas": rng.normal(0, 0.5, 300).astype(np.float32),
            "poses": rng.uniform(-spread, spread, (n, 165)).astype(np.float32),
            "expressions": rng.uniform(-1, 1, (n, 100)).astype(np.float32),
            "trans": rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_surface_archive(tmp_path_factory.mktemp("viz") / "SMPLX_NEUTRAL_2020.npz")
    return jsmplx.load_smplx(path), smplx.load_smplx(path, "cpu")


# -- the rasterizer ---------------------------------------------------------------------

def _triangle():
    verts = np.array([[[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.5, -2.0]]], np.float32)
    return verts, np.array([[0, 1, 2]], np.int32), (64, 64), {"light_dir": (0, 0, 1)}


def _zbuffer():
    verts, _, size, kw = _triangle()
    verts = np.concatenate([verts, verts - np.asarray([0, 0, -1], np.float32)], 1)
    return verts, np.array([[0, 1, 2], [3, 4, 5]], np.int32), size, kw


def _grid_two_frames():
    verts, faces = ellipsoid_mesh(8, 12)
    rng = np.random.RandomState(3)
    frames = np.stack([verts, verts + rng.normal(0, 0.01, verts.shape)]).astype(np.float32)
    cam = mesh_video.world_to_camera(frames)
    return cam, faces.astype(np.int32), (48, 72), {"light_dir": mesh_video._light_dir_camera()}


@pytest.mark.parametrize("case", [_triangle, _zbuffer, _grid_two_frames])
def test_rasterizer_frames_equal_the_jax_build(case):
    verts, faces, (w, h), kw = case()
    got = native.render_mesh_frames(verts, faces, w, h, **kw)
    want = jax_render_mesh_frames(verts, faces, w, h, **kw)
    assert got.dtype == np.uint8 and got.shape == (len(verts), h, w, 3)
    assert got.tobytes() == want.tobytes()
    if case is _triangle:
        assert got[0, 32, 32].sum() > 100 and got[0, 2, 2].sum() == 0
    if case is _zbuffer:
        assert got[0, 32, 32].sum() > 0
    if case is _grid_two_frames:
        assert (got > 0).any(-1).sum() > 100


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ build of broken.cpp failed"):
        native.build("broken")
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))


# -- projection and FK ------------------------------------------------------------------

def test_project_perspective_matches_jax():
    pts = np.random.RandomState(2).uniform(-0.8, 0.8, (7, 80, 3)).astype(np.float32)
    want = jrender.project_perspective(pts, 1000.0, 720, 480, (0.0, -1.0, 3.0))
    got = render2d.project_perspective(torch.from_numpy(pts), 1000.0, 720, 480,
                                       (0.0, -1.0, 3.0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("remove_global,face_only", [(False, False), (True, False), (True, True)])
def test_joints_from_motion_matches_jax(models, remove_global, face_only):
    jm, pm = models
    data = motion(6)
    want = jrender.joints_from_motion(jm, data, remove_global, face_only)
    got = render2d.joints_from_motion(pm, data, remove_global, face_only)
    assert got.shape == want.shape == (6, 127, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"remove_transl": False},
                                {"zero_body": True, "scale": 7.0, "y_shift": 10.0}])
def test_fk_vertices_match_jax(models, kw):
    jm, pm = models
    data = motion(5, seed=4)
    want = jmesh._fk_vertices(jm, data, **kw)
    got = mesh_video._fk_vertices(pm, data, **kw)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- drawing ----------------------------------------------------------------------------

def _screen_joints(seed, spread):
    pts = np.random.RandomState(seed).uniform(-spread, spread, (127, 3)).astype(np.float32)
    pts[:, 2] *= 0.2
    return jrender.project_perspective(pts, 1000.0, 720, 480, (0.0, -1.0, 3.0))


@pytest.mark.parametrize("seed,spread,face_only", [
    (0, 0.5, False), (1, 0.5, True), (2, 1.2, False),  # 1.2: joints off the canvas, clipped
    (3, 0.05, False),                                   # bunched: most bones overlap
    (4, None, False)])                                  # a standing person
def test_draw_frame_equals_cv2(seed, spread, face_only):
    j2d = humanoid_j2d(seed) if spread is None else _screen_joints(seed, spread)
    want = jrender.draw_frame(j2d, 720, 480, face_only=face_only)
    got = render2d.draw_frame(j2d, 720, 480, face_only=face_only)
    assert got.dtype == np.uint8 and got.shape == want.shape == (720, 480, 3)
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_draw_frames_batches_frames_independently():
    j2d = torch.from_numpy(np.stack([_screen_joints(s, 0.5) for s in range(3)]))
    batch = render2d.draw_frames(j2d, 120, 96)
    for i in range(3):
        assert torch.equal(batch[i], render2d.draw_frames(j2d[i:i + 1], 120, 96)[0])


def _cv2_canvas(call, h=60, w=80):
    img = np.zeros((h, w, 3), np.uint8)
    call(img)
    return img[..., 0] > 0


def _mask(runs=(), pixels=(), h=60, w=80):
    z = lambda t: torch.zeros_like(t)
    r = [(z(i), y, x1, x2, z(i)) for i, y, x1, x2 in runs]
    p = [(z(i), y, x, z(i)) for i, y, x in pixels]
    return draw.paint(1, h, w, r, p, np.array([[255, 255, 255]]), "cpu")[0, ..., 0].numpy() > 0


@pytest.mark.parametrize("primitive", ["line", "circle", "thick_line", "ellipse_fill"])
def test_primitives_equal_cv2(primitive):
    """Each primitive against cv2's own call on random inputs, many partly or wholly off
    the 80 x 60 canvas."""
    rng = np.random.RandomState(["line", "circle", "thick_line", "ellipse_fill"].index(primitive))
    t = lambda *v: torch.as_tensor(np.array(v), dtype=torch.int64)
    for _ in range(60):
        if primitive == "line":
            p = [int(v) for v in rng.randint(-40, 120, 4)]
            want = _cv2_canvas(lambda im: cv2.line(im, p[:2], p[2:], (255, 255, 255), 1))
            seg, y, x = draw.line_pixels(*(t(v) for v in p), 80, 60)
            got = _mask(pixels=[(seg, y, x)])
        elif primitive == "circle":
            c, r = [int(v) for v in rng.randint(-6, 86, 2)], int(rng.choice([1, 3, 4]))
            want = _cv2_canvas(lambda im: cv2.circle(im, c, r, (255, 255, 255), -1))
            got = _mask(runs=[draw.circle_runs(t(c[0]), t(c[1]), r)])
        elif primitive == "thick_line":
            p = [int(v) for v in rng.randint(-40, 120, 4)]
            want = _cv2_canvas(lambda im: cv2.line(im, p[:2], p[2:], (255, 255, 255), 2))
            runs, pix = draw.thick_line(*(t(v) for v in p), 80, 60)
            got = _mask(runs=[runs], pixels=[pix])
        else:
            c, a, ang = [int(v) for v in rng.randint(-10, 90, 2)], int(rng.randint(0, 50)), \
                int(rng.randint(-180, 181))
            poly = cv2.ellipse2Poly(c, (a, 4), ang, 0, 360, 1)
            vx, vy = draw.ellipse_poly(t(c[0]), t(c[1]), t(a), 4, t(ang))
            pts = np.stack([vx[0].numpy(), vy[0].numpy()], 1)
            fresh = np.concatenate([[True], (pts[1:] != pts[:-1]).any(1)])
            np.testing.assert_array_equal(pts[fresh], poly)
            want = _cv2_canvas(lambda im: cv2.fillConvexPoly(im, poly, (255, 255, 255)))
            runs, outline = draw.convex_fill(vx, vy, 0, 80, 60)
            got = _mask(runs=[runs], pixels=[outline])
        np.testing.assert_array_equal(got, want)


# -- JPEG -------------------------------------------------------------------------------

def _segments(data: bytes):
    """(marker, payload) of every segment before the scan."""
    out, i = [], 2
    while True:
        marker, length = data[i + 1], struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((marker, data[i + 4:i + 2 + length]))
        if marker == 0xDA:
            return out
        i += 2 + length


def _mesh_frame(models):
    jm, pm = models
    verts = mesh_video._fk_vertices(pm, motion(1, seed=6))
    return np.ascontiguousarray(mesh_video.render_frames(verts, pm.faces)[0, :, :, ::-1])


def humanoid_j2d(seed=0):
    """(127, 3) screen joints laid out as a standing person in a 480 x 720 frame (body,
    two five-finger hands, 51 face landmarks), jittered from ``seed``: a skeleton frame
    shaped like the renders of real motion."""
    rng = np.random.RandomState(seed)
    j = np.zeros((127, 3), np.float32)
    body = {1: (270, 390), 2: (210, 390), 4: (275, 520), 5: (205, 520), 7: (280, 650),
            8: (200, 650), 12: (240, 200), 16: (290, 215), 17: (190, 215), 18: (320, 300),
            19: (160, 300), 20: (330, 380), 21: (150, 380), 55: (240, 150), 56: (230, 140),
            57: (250, 140), 58: (220, 145), 59: (260, 145)}
    for i, xy in body.items():
        j[i, :2] = xy
    for chains in (jrender._L_FINGER_CHAINS, jrender._R_FINGER_CHAINS):
        for f, chain in enumerate(chains):
            ang = np.deg2rad(60 + 15 * f)
            for k, idx in enumerate(chain[1:], start=1):
                j[idx, :2] = j[chain[0], :2] + 8 * k * np.array([np.cos(ang), np.sin(ang)])
    t = np.linspace(0, 2 * np.pi, 51, endpoint=False)
    j[76:, 0], j[76:, 1] = 240 + 22 * np.cos(t), 150 + 28 * np.sin(t)
    j[:, :2] += rng.normal(0, 1.5, (127, 2))
    return j


def _skeleton_frame():
    return jrender.draw_frame(humanoid_j2d(7), 720, 480)


def test_jpeg_tables_equal_cv2():
    frame = _skeleton_frame()
    got = _segments(jpeg.encode_frames(frame[None])[0])
    want = _segments(cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes())
    for marker in (0xDB, 0xC4, 0xC0, 0xDA):  # DQT, DHT, SOF0, SOS
        assert [p for m, p in got if m == marker] == [p for m, p in want if m == marker]


@pytest.mark.parametrize("source", ["mesh", "skeleton"])
def test_jpeg_psnr_matches_cv2(models, source):
    frame = _mesh_frame(models) if source == "mesh" else _skeleton_frame()
    assert frame.any()
    psnr = lambda a: 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - frame) ** 2))
    ours = cv2.imdecode(np.frombuffer(jpeg.encode_frames(frame[None])[0], np.uint8), 1)
    theirs = cv2.imdecode(cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 90])[1], 1)
    assert ours.shape == frame.shape
    assert psnr(ours) >= 35.0
    assert abs(psnr(ours) - psnr(theirs)) <= 1.0


def test_jpeg_pads_sizes_that_are_not_whole_mcus():
    frame = np.random.RandomState(8).randint(0, 256, (37, 50, 3)).astype(np.uint8)
    frame = cv2.GaussianBlur(frame, (9, 9), 3)
    decoded = cv2.imdecode(np.frombuffer(jpeg.encode_frames(frame[None])[0], np.uint8), 1)
    assert decoded.shape == frame.shape
    assert np.abs(decoded.astype(int) - frame).mean() < 2.0


# -- AVI --------------------------------------------------------------------------------

def _frames_and_audio():
    rng = np.random.RandomState(9)
    frames = [np.full((32, 48, 3), c, np.uint8) for c in (10, 120, 240)]
    return frames, rng.uniform(-0.5, 0.5, 1700).astype(np.float32)


def _cv2_read(path):
    cap = cv2.VideoCapture(path)
    fps, frames = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return fps, frames


def test_cv2_reads_the_avi_as_the_jax_one(tmp_path):
    frames, audio = _frames_and_audio()
    ours = avi.write_avi(str(tmp_path / "port.avi"), frames, fps=30, audio=audio)
    theirs = javi.write_avi(str(tmp_path / "jax.avi"), frames, fps=30, audio=audio)
    (fps_o, got), (fps_t, want) = _cv2_read(ours), _cv2_read(theirs)
    assert fps_o == fps_t == 30
    assert len(got) == len(want) == 3 and got[0].shape == want[0].shape == (32, 48, 3)
    assert all(abs(int(g.mean()) - c) < 3 for g, c in zip(got, (10, 120, 240)))


def test_avi_headers_and_audio_equal_the_jax_file(tmp_path):
    frames, audio = _frames_and_audio()
    ours = avi.read_avi(avi.write_avi(str(tmp_path / "port.avi"), frames, 30, audio))
    theirs = avi.read_avi(javi.write_avi(str(tmp_path / "jax.avi"), frames, 30, audio))
    assert ours["audio"].tobytes() == theirs["audio"].tobytes()
    assert len(ours["audio"]) == 1700
    for key in ("fps", "width", "height", "n_frames", "sample_rate"):
        assert ours[key] == theirs[key]
    hdrl = lambda p: open(p, "rb").read()[12:12 + 8 + struct.unpack_from(
        "<I", open(p, "rb").read(), 16)[0]]
    assert hdrl(str(tmp_path / "port.avi")) == hdrl(str(tmp_path / "jax.avi"))


def test_add_audio_keeps_the_jpeg_payloads(tmp_path):
    from pantomatrix_tpu_torch.data.audio import load_audio
    from test_data_pipeline import write_wav

    frames, audio = _frames_and_audio()
    silent = avi.write_avi(str(tmp_path / "silent.avi"), frames, fps=30)
    write_wav(tmp_path / "a.wav", audio, 16000)
    out = avi.add_audio_to_video(silent, str(tmp_path / "a.wav"), str(tmp_path / "out.mp4"))
    assert out.endswith("out.avi")
    before, after = avi.read_avi(silent), avi.read_avi(out)
    assert after["jpegs"] == before["jpegs"] and after["fps"] == 30
    want = (np.clip(load_audio(str(tmp_path / "a.wav"), 16000), -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(after["audio"], want)


def test_read_avi_checks_the_index(tmp_path):
    frames, audio = _frames_and_audio()
    path = avi.write_avi(str(tmp_path / "v.avi"), frames, fps=30, audio=audio)
    data = bytearray(open(path, "rb").read())
    idx = data.rindex(b"idx1")
    struct.pack_into("<I", data, idx + 8 + 8, 12345)  # the first entry's offset
    bad = tmp_path / "bad.avi"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="idx1"):
        avi.read_avi(str(bad))
    with pytest.raises(ValueError):
        avi.write_avi_jpegs(str(tmp_path / "short.avi"), [b"x"], 2, 8, 8)
