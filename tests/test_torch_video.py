"""The port's video reader, burn-in, feature cache, fetch API and prefetch
loader against the JAX package's, on the CPU.

Every comparison is exact: both packages decode the same mp4 (written here
by cv2.VideoWriter) with the same cv2 calls, draw the same PIL overlays and
patchify with the same numpy code, so frames, geometry and patches (float32
and float16) must be bit-equal, and the cache keys equal strings.
"""

import base64
import dataclasses
import inspect
import io
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from video_r2_tpu.data import prefetch as jprefetch
from video_r2_tpu.video import api as japi
from video_r2_tpu.video import cache as jcache
from video_r2_tpu.video import overlay as joverlay
from video_r2_tpu.video import reader as jreader
from video_r2_tpu.video import srt as jsrt
from video_r2_tpu_torch.data import prefetch
from video_r2_tpu_torch.video import api
from video_r2_tpu_torch.video import cache
from video_r2_tpu_torch.video import overlay
from video_r2_tpu_torch.video import preprocess
from video_r2_tpu_torch.video import reader
from video_r2_tpu_torch.video import srt

SRT = """1
00:00:00,000 --> 00:00:01,500
The <i>person</i> walks in.

2
00:00:01,500 --> 00:00:03,000
They pick up a red cup
and drink from it.

3
00:00:05,000 --> 00:00:06,000
Done.
"""


@pytest.fixture(autouse=True)
def _no_feature_cache(monkeypatch):
    monkeypatch.delenv("VR2_VIDEO_CACHE", raising=False)


def _write_mp4(path, n=60, hw=(48, 64), fps=10.0):
    """A clip whose frames differ in every pixel row and column."""
    h, w = hw
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        f = np.stack([(xx * 4 + i * 3) % 256, (yy * 5 + i * 7) % 256,
                      np.full_like(xx, (i * 11) % 256)], -1).astype(np.uint8)
        vw.write(f)
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    path = _write_mp4(d / "clip.mp4")
    (d / "clip.srt").write_text(SRT)
    return path


def _decoded_equal(ours, ref):
    np.testing.assert_array_equal(ours.frames, ref.frames)
    assert dataclasses.astuple(ours.geometry) == dataclasses.astuple(ref.geometry)
    assert (ours.video_fps, ours.clip_start) == (ref.video_fps, ref.clip_start)


def test_srt_copy_matches(clip, tmp_path):
    for name in ("srt_time_to_seconds", "parse_srt_text", "parse_srt_file",
                 "SubtitleIndex", "resolve_srt_path_for_video"):
        assert inspect.getsource(getattr(srt, name)) == inspect.getsource(
            getattr(jsrt, name)), name
    cues = srt.parse_srt_text(SRT)
    assert cues == jsrt.parse_srt_text(SRT) and len(cues) == 3
    ours, ref = srt.SubtitleIndex(cues), jsrt.SubtitleIndex(cues)
    last_o = last_r = 0
    for t in (-0.04, 0.0, 1.49, 1.5, 2.99, 3.04, 4.0, 5.5, 7.0):
        a, last_o = ours.get(t, last_o)
        b, last_r = ref.get(t, last_r)
        assert (a, last_o) == (b, last_r), t
    assert srt.resolve_srt_path_for_video(clip) == jsrt.resolve_srt_path_for_video(clip)
    assert srt.resolve_srt_path_for_video(str(tmp_path / "none.mp4")) is None
    assert srt.parse_srt_file(clip[:-4] + ".srt") == jsrt.parse_srt_file(clip[:-4] + ".srt")


@pytest.mark.parametrize("path", ["sequential", "seek"])
@pytest.mark.parametrize("ele", [{"nframes": 8}, {"fps": 2.0, "video_start": 1.0,
                                                  "video_end": 5.0}],
                         ids=["nframes", "fps_range"])
def test_reader_matches_jax(clip, monkeypatch, path, ele):
    """Frames and geometry equal through the sequential pass and through
    the seek path (its gap threshold lowered so this clip takes it)."""
    if path == "seek":
        monkeypatch.setenv("VIDEO_SEEK_GAP_THRESHOLD", "1")
    seen = []
    seek = reader._read_frames_seek
    monkeypatch.setattr(reader, "_read_frames_seek",
                        lambda *a, **k: seen.append(1) or seek(*a, **k))
    e = {"video": clip, **ele}
    ours = reader.decode_video(e, 32, 128000 * 28 * 28)
    ref = jreader.decode_video(e, 32, 128000 * 28 * 28)
    _decoded_equal(ours, ref)
    assert bool(seen) == (path == "seek")
    assert reader.probe_video_cv2(clip) == jreader.probe_video_cv2(clip)
    assert ours.frames.shape[1:] == (48, 64, 3)


def test_seek_probe_fallback_matches_jax(clip, monkeypatch):
    """When the probe frame disagrees with the sequential pass, both seek
    readers return nothing, and the decode falls back to the sequential
    pass with the same frames."""
    monkeypatch.setenv("VIDEO_SEEK_GAP_THRESHOLD", "1")
    e = {"video": clip, "nframes": 8}
    want = sorted(set(jreader.decode_video(e, 32, 10 ** 9).geometry.frame_indices))
    assert reader._read_frames_seek(clip, want) and jreader._read_frames_seek(clip, want)
    monkeypatch.setenv("VIDEO_SEEK_GAP_THRESHOLD", "1000")
    sequential = reader.decode_video(e, 32, 10 ** 9)
    monkeypatch.setenv("VIDEO_SEEK_GAP_THRESHOLD", "1")
    monkeypatch.setattr(np, "array_equal", lambda a, b: False)   # the probe fails
    assert reader._read_frames_seek(clip, want) == {}
    assert jreader._read_frames_seek(clip, want) == {}
    monkeypatch.undo()
    monkeypatch.setenv("VIDEO_SEEK_GAP_THRESHOLD", "1")
    orig = np.array_equal
    monkeypatch.setattr(np, "array_equal",
                        lambda a, b: False if a.shape == (48, 64, 3) else orig(a, b))
    ours, ref = reader.decode_video(e, 32, 10 ** 9), jreader.decode_video(e, 32, 10 ** 9)
    monkeypatch.undo()
    _decoded_equal(ours, ref)
    np.testing.assert_array_equal(ours.frames, sequential.frames)


def test_frames_reader_matches_jax(rng):
    frames = rng.integers(0, 256, (9, 56, 84, 3), np.uint8)
    for e in ({"video": frames, "nframes": 4}, {"video": list(frames), "video_fps": 3.0},
              {"video": frames, "fps": 1.0, "video_fps": 2.0, "video_start": 1.0}):
        _decoded_equal(reader.decode_video(e, 32, 10 ** 9),
                       jreader.decode_video(e, 32, 10 ** 9))


def test_overlay_matches_jax(rng):
    for name in ("choose_timestamp_color", "_measure", "_wrap"):
        assert inspect.getsource(getattr(overlay, name)) == inspect.getsource(
            getattr(joverlay, name)), name
    for hw in ((48, 64), (336, 448)):
        frame = rng.integers(0, 256, (*hw, 3), np.uint8)
        dark = (frame // 4).astype(np.uint8)
        for f in (frame, dark):
            assert overlay.choose_timestamp_color(f) == joverlay.choose_timestamp_color(f)
            np.testing.assert_array_equal(overlay.draw_timestamp(f, "00:01:02"),
                                          joverlay.draw_timestamp(f, "00:01:02"))
            text = "They pick up a red cup and drink from it slowly\nthen leave"
            np.testing.assert_array_equal(overlay.draw_subtitle(f, text),
                                          joverlay.draw_subtitle(f, text))
            assert overlay.draw_subtitle(f, "") is f


@pytest.mark.parametrize("what", ["timestamps", "subtitles", "both"])
def test_burn_in_matches_jax(clip, what):
    """Timestamps and the sibling .srt burned into the decoded frames:
    equal exactly, and different from the plain frames."""
    ts, sub = what in ("timestamps", "both"), what in ("subtitles", "both")
    e = {"video": clip, "nframes": 8}
    ours = api.burn_in(reader.decode_video(e, 32, 10 ** 9), e,
                       api.VideoPreprocessConfig(write_timestamps=ts, write_subtitles=sub))
    ref = japi.burn_in(jreader.decode_video(e, 32, 10 ** 9), e,
                       japi.VideoPreprocessConfig(write_timestamps=ts, write_subtitles=sub))
    np.testing.assert_array_equal(ours, ref)
    plain = reader.decode_video(e, 32, 10 ** 9).frames
    assert not np.array_equal(ours, plain)


@pytest.mark.parametrize("patch_dtype", ["float32", "float16"])
def test_fetch_video_file_matches_jax(clip, patch_dtype):
    """A file through fetch_video, with burn-in: equal patches (in the
    patch dtype), grid_thw, sample_fps and temporal scale."""
    e = {"video": clip, "fps": 2.0, "min_pixels": 4 * 28 * 28, "max_pixels": 56 * 84}
    kw = dict(write_timestamps=True, write_subtitles=True, patch_dtype=patch_dtype)
    ours = api.fetch_video(e, api.VideoPreprocessConfig(**kw))
    ref = japi.fetch_video(e, japi.VideoPreprocessConfig(**kw))
    assert ours.patches.dtype == ref.patches.dtype == np.dtype(patch_dtype)
    np.testing.assert_array_equal(ours.patches, ref.patches)
    assert (ours.grid_thw, ours.sample_fps, ours.second_per_grid_t) == (
        ref.grid_thw, ref.sample_fps, ref.second_per_grid_t)
    assert ours.num_tokens == ref.num_tokens


def test_frames_branch_is_unchanged(rng):
    """Decoded frames at the planned size: the same features as before the
    reader was ported (the planned frames through video_features), and as
    the JAX package's."""
    frames = rng.integers(0, 256, (7, 112, 168, 3), np.uint8)
    e = {"video": frames, "video_fps": 1.5, "min_pixels": 4 * 28 * 28,
         "max_pixels": 112 * 168, "fps": 1.0}
    ours = api.fetch_video(e)
    ref = japi.fetch_video(e)
    plan = jreader.decode_video(e, 32, api.VideoPreprocessConfig().video_total_pixels).geometry
    before = api.video_features(frames[list(plan.frame_indices)], plan.resized_height,
                                plan.resized_width, plan.sample_fps)
    for other in (ref, before):
        np.testing.assert_array_equal(ours.patches, other.patches)
        assert (ours.grid_thw, ours.sample_fps, ours.second_per_grid_t) == (
            other.grid_thw, other.sample_fps, other.second_per_grid_t)


def test_feature_cache_matches_jax(clip, tmp_path, monkeypatch):
    """The cache key equals the JAX package's for the same element and
    config; a second fetch is served from the cache without decoding."""
    for name in ("feature_cache_key",):
        assert inspect.getsource(getattr(cache, name)) == inspect.getsource(
            getattr(jcache, name))
    e = {"video": clip, "nframes": 4, "subtitles": None}
    for kw in ({}, {"write_subtitles": True, "patch_dtype": "float16"}):
        key = cache.feature_cache_key(e, api.VideoPreprocessConfig(**kw), clip)
        assert key == jcache.feature_cache_key(e, japi.VideoPreprocessConfig(**kw), clip)
    assert cache.feature_cache_key(e, api.VideoPreprocessConfig(),
                                   str(tmp_path / "missing.mp4")) is None
    cfg = api.VideoPreprocessConfig(cache_dir=str(tmp_path / "cache"))
    first = api.fetch_video(e, cfg)
    assert len(list((tmp_path / "cache").glob("*.npz"))) == 1
    monkeypatch.setattr(api, "decode_video", lambda *a, **k: pytest.fail("decoded twice"))
    hit = api.fetch_video(e, cfg)
    np.testing.assert_array_equal(hit.patches, first.patches)
    assert (hit.grid_thw, hit.sample_fps, hit.second_per_grid_t) == (
        first.grid_thw, first.sample_fps, first.second_per_grid_t)
    # past a byte budget smaller than any entry, eviction drops them all
    small = cache.FeatureCache(str(tmp_path / "cache"), max_bytes=1)
    small.put("other", first)
    assert [p.stem for p in (tmp_path / "cache").glob("*.npz")] == []


def test_fetch_image_and_process_vision_info_match_jax(clip, tmp_path, rng):
    img = rng.integers(0, 256, (70, 90, 3), np.uint8)
    png = tmp_path / "im.png"
    Image.fromarray(img).save(png)
    buf = io.BytesIO()
    Image.fromarray(img).convert("RGBA").save(buf, format="PNG")
    b64 = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    for ele in ({"image": str(png)}, {"image": "file://" + str(png)},
                {"image_url": b64, "min_pixels": 56 * 56, "max_pixels": 112 * 112},
                {"image": str(png), "resized_height": 56, "resized_width": 84}):
        ours, ref = api.fetch_image(ele), japi.fetch_image(ele)
        np.testing.assert_array_equal(ours.patches, ref.patches)
        assert ours.grid_thw == ref.grid_thw
    conv = [{"role": "user", "content": [
        {"type": "image", "image": str(png)},
        {"type": "video", "video": clip, "nframes": 4},
        {"type": "video", "video": [str(png)] * 3, "fps": 1.0},
        {"type": "text", "text": "What?"}]}]
    assert api.extract_vision_info(conv) == japi.extract_vision_info(conv)
    (oi, ov), (ri, rv) = api.process_vision_info(conv), japi.process_vision_info(conv)
    for a, b in zip(oi + ov, ri + rv):
        np.testing.assert_array_equal(a.patches, b.patches)
        assert a.grid_thw == b.grid_thw
    assert [v.sample_fps for v in ov] == [v.sample_fps for v in rv]
    assert api.process_vision_info([{"role": "user", "content": "hi"}]) == (None, None)


def _double(idx):
    return [2 * i for i in idx]


def _fail_at_3(idx):
    if 3 in idx:
        raise ValueError("bad batch 3")
    return list(idx)


@pytest.mark.parametrize("procs", [False, True], ids=["threads", "processes"])
def test_prefetch_matches_jax(procs):
    """In-order results, and a failing batch raised at its turn: a
    ValueError from threads, a WorkerError from processes."""
    batches = [[i, i + 1] for i in range(0, 12, 2)]
    for mod in (prefetch, jprefetch):
        loader = mod.PrefetchLoader(iter(batches), _double, num_workers=3, prefetch=2,
                                    use_processes=procs)
        try:
            assert list(loader) == [_double(b) for b in batches]
        finally:
            loader.close()
    got = {}
    for name, mod in (("port", prefetch), ("jax", jprefetch)):
        loader = mod.PrefetchLoader(([i] for i in range(6)), _fail_at_3, num_workers=2,
                                    use_processes=procs)
        out = []
        try:
            while True:
                item = loader.poll() if len(out) == 5 else next(loader)
                if item is not None:
                    out.append(item)
        except StopIteration:
            pass
        except Exception as e:  # noqa: BLE001
            got[name] = (out, type(e).__name__, "bad batch 3" in str(e))
        finally:
            loader.close()
    assert got["port"] == got["jax"]
    assert got["port"] == ([[0], [1], [2]], "WorkerError" if procs else "ValueError", True)
    assert issubclass(prefetch.WorkerError, RuntimeError)


def test_missing_cv2_or_pil_raises_import_error(clip, monkeypatch, rng):
    """No fallback: a missing cv2 or PIL raises an ImportError naming it."""
    frame = rng.integers(0, 256, (56, 56, 3), np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        api.fetch_video({"video": clip, "nframes": 4})
    with pytest.raises(ImportError, match="cv2"):
        reader.probe_video_cv2(clip)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for call in (lambda: overlay.draw_timestamp(frame, "00:00:01"),
                 lambda: overlay.draw_subtitle(frame, "hi"),
                 lambda: api.fetch_image({"image": "x.png"}),
                 lambda: preprocess.preprocess_frames_host(frame[None], 28, 56)):
        with pytest.raises(ImportError, match="PIL"):
            call()
    # decoded frames at their planned size need neither
    e = {"video": np.stack([frame] * 4), "min_pixels": 4 * 28 * 28}
    assert api.fetch_video(e).grid_thw == (2, 4, 4)


def test_device_preprocess_backend_raises():
    frames = np.zeros((2, 56, 56, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.fetch_video({"video": frames}, api.VideoPreprocessConfig(
            preprocess_backend="device"))
    patches, grid = preprocess.preprocess_frames_np(frames, 56, 56)
    assert grid == (1, 4, 4) and patches.shape == (16, 1176)
