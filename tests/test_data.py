"""Sample I/O: .vec round-trip vs reference fixture, negative-miner schedule."""

import os

import numpy as np
import pytest

from cascadeclassifier_tpu.data.negreader import NegReader, read_bg_list
from cascadeclassifier_tpu.data.vec import PosReader, VecError, read_vec, write_vec

REF_RES = "/root/reference/traincascade/res"
fixtures = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_RES, "barcode.vec")),
    reason="reference fixtures not mounted",
)


@fixtures
def test_read_reference_vec():
    v = read_vec(os.path.join(REF_RES, "barcode.vec"), 75, 32)
    assert v.shape == (100, 32, 75)
    assert v.dtype == np.uint8
    assert v.max() > 0


def test_vec_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    s = rng.integers(0, 256, (7, 24, 24)).astype(np.uint8)
    p = str(tmp_path / "t.vec")
    write_vec(p, s)
    np.testing.assert_array_equal(read_vec(p, 24, 24), s)


def test_pos_reader_semantics(tmp_path):
    s = np.arange(3 * 4 * 4, dtype=np.uint8).reshape(3, 4, 4)
    p = str(tmp_path / "t.vec")
    write_vec(p, s)
    r = PosReader(p, 4, 4)
    np.testing.assert_array_equal(r.get(), s[0])
    np.testing.assert_array_equal(r.take(2), s[1:])
    with pytest.raises(VecError):
        r.get()
    r.restart()
    np.testing.assert_array_equal(r.get(), s[0])


def test_bg_list_parsing(tmp_path):
    p = str(tmp_path / "bg.txt")
    with open(p, "w") as f:
        f.write("# comment\nimg1.png\nimg2.png\n\nimg_after_blank.png\n")
    # reference semantics: empty line terminates (imagestorage.cpp:46)
    assert read_bg_list(p) == ["img1.png", "img2.png"]


@fixtures
def test_negreader_schedule_deterministic(tmp_path):
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write(os.path.join(REF_RES, "bg.png") + "\n")
    r1 = NegReader(bg, 24, 24)
    b1 = r1.take_batch(50)
    r2 = NegReader(bg, 24, 24)
    b2 = r2.take_batch(50)
    assert b1.shape == (50, 24, 24)
    np.testing.assert_array_equal(b1, b2)
    # windows must not all be equal (the schedule moves)
    assert not np.array_equal(b1[0], b1[1])


@fixtures
def test_negreader_windows_match_reference_library(tmp_path):
    """Byte-exact window stream vs the reference NegReader (golden oracle
    linking the reference library; see oracle/dump_negreader.cpp)."""
    import subprocess

    oracle = "/root/repo/oracle/dump_negreader"
    if not os.path.exists(oracle):
        r = subprocess.run(
            ["make", "-C", "/root/repo/oracle", "dump_negreader"],
            capture_output=True,
        )
        if not os.path.exists(oracle):
            pytest.skip("negreader oracle not buildable")
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write(os.path.join(REF_RES, "bg.png") + "\n")
    out = subprocess.run(
        [oracle, bg, "24", "24", "150"], capture_output=True, text=True
    ).stdout.split()
    if "END" in out:
        out = out[: out.index("END")]
    ref = np.array(out, np.int32).reshape(-1, 24, 24)
    mine = NegReader(bg, 24, 24).take_batch(150)[: len(ref)]
    np.testing.assert_array_equal(mine.astype(np.int32), ref)


def test_native_io_matches_python(tmp_path):
    """C++ IO runtime (csrc/) must be byte-identical to the Python path."""
    from cascadeclassifier_tpu.data import native

    if native.get_lib() is None:
        import subprocess

        subprocess.run(["make", "-C", "/root/repo/csrc"], capture_output=True)
        native._TRIED = False
        if native.get_lib() is None:
            pytest.skip("native IO library not buildable")

    rng = np.random.default_rng(0)
    s = rng.integers(0, 256, (9, 14, 10)).astype(np.uint8)
    p = str(tmp_path / "n.vec")
    assert native.native_write_vec(p, s)
    np.testing.assert_array_equal(read_vec(p, 10, 14), s)
    nv = native.native_read_vec(p)
    np.testing.assert_array_equal(nv.reshape(9, 14, 10), s)

    if os.path.exists(os.path.join(REF_RES, "bg.png")):
        bg = str(tmp_path / "bg.txt")
        with open(bg, "w") as f:
            f.write(os.path.join(REF_RES, "bg.png") + "\n")
        py = NegReader(bg, 24, 24).take_batch(120)
        nat = native.NativeNegReader(bg, 24, 24).take_batch(120)
        np.testing.assert_array_equal(py, nat)


def test_missing_files_error_paths(tmp_path):
    """CvCascadeImageReader::create failure semantics on missing inputs."""
    with pytest.raises((FileNotFoundError, VecError, OSError)):
        PosReader(str(tmp_path / "nope.vec"), 24, 24)
    with pytest.raises(FileNotFoundError):
        NegReader(str(tmp_path / "nope.txt"), 24, 24)
    # bg list with only unreadable entries → miner yields nothing
    bg = str(tmp_path / "bad.txt")
    with open(bg, "w") as f:
        f.write(str(tmp_path / "missing.png") + "\n")
    r = NegReader(bg, 24, 24)
    assert r.take_batch(3).shape[0] == 0


def _synth_bg(tmp_path, n=2, hw=((70, 90), (55, 62))):
    import cv2

    rng = np.random.default_rng(7)
    names = []
    for i, (h, w) in enumerate(hw[:n]):
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        p = str(tmp_path / f"bg{i}.png")
        cv2.imwrite(p, img)
        names.append(p)
    bg = str(tmp_path / "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    return bg


def test_negreader_level_walk_matches_get(tmp_path):
    """level_positions + skip (device-mining API) must replay the exact
    get() window stream, including mid-level resume and level/image
    transitions (imagestorage.cpp:90-126)."""
    bg = _synth_bg(tmp_path)
    ref = NegReader(bg, 24, 24).take_batch(400)

    r = NegReader(bg, 24, 24)
    # consume a prefix one-at-a-time so the first level walk starts
    # mid-level (the resume case the trainer hits after a stop)
    got = [r.get() for _ in range(7)]
    while len(got) < len(ref):
        img, pos = r.level_positions()
        take = min(len(pos), len(ref) - len(got))
        for px, py in pos[:take]:
            got.append(img[py : py + 24, px : px + 24].copy())
        r.skip(int(take))
    np.testing.assert_array_equal(np.stack(got)[: len(ref)], ref)


def test_negreader_state_snapshot_rewind(tmp_path):
    """state()/set_state() + skip(k) rewinds the schedule exactly (the
    trainer's stop-mid-superbatch path)."""
    bg = _synth_bg(tmp_path)
    r = NegReader(bg, 24, 24)
    r.take_batch(30)
    st = r.state()
    a = r.take_batch(60)
    r.set_state(st)
    r.skip(13)
    b = r.take_batch(47)
    np.testing.assert_array_equal(a[13:], b)


def test_negreader_skip_equals_repeated_advance(tmp_path):
    """Vectorized skip(k) must equal k repeated _advance() calls across
    window, row, level and image boundaries for every k."""
    bg = _synth_bg(tmp_path)
    ref = NegReader(bg, 24, 24)
    ref.get()  # position on the first window
    fast = NegReader(bg, 24, 24)
    fast.get()
    rng = np.random.default_rng(5)
    for _ in range(40):
        k = int(rng.integers(1, 900))
        ok_ref = all(ref._advance() for _ in range(k))
        ok_fast = fast.skip(k)
        assert ok_ref == ok_fast
        assert ref.point == fast.point and ref.last == fast.last
        assert ref.scale == fast.scale and ref.offset == fast.offset
        assert ref.img.shape == fast.img.shape


def test_pgm_roundtrip_and_header_comments(tmp_path):
    from cascadeclassifier_tpu.data.negreader import (
        imread_gray,
        read_pgm,
        write_pgm,
    )

    img = np.random.default_rng(3).integers(0, 256, (37, 53)).astype(np.uint8)
    p = str(tmp_path / "a.pgm")
    write_pgm(p, img)
    assert np.array_equal(read_pgm(p), img)
    assert np.array_equal(imread_gray(p), img)
    # comments and odd whitespace in the header, as other writers emit
    q = tmp_path / "b.pgm"
    q.write_bytes(b"P5\n# made by hand\n53  37\n# max\n255\n" + img.tobytes())
    assert np.array_equal(read_pgm(str(q)), img)
    assert imread_gray(str(tmp_path / "missing.pgm")) is None
    with pytest.raises(ValueError):
        (tmp_path / "c.pgm").write_bytes(b"P2\n1 1\n255\n0\n")
        read_pgm(str(tmp_path / "c.pgm"))


def test_negreader_reads_pgm_without_cv2(tmp_path, monkeypatch):
    """The training path's background reader needs no OpenCV bindings
    for PGM backgrounds, and yields the same windows as from PNG."""
    import sys

    from cascadeclassifier_tpu.data.negreader import write_pgm

    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (60, 80)).astype(np.uint8) for _ in range(2)]
    lists = {}
    for ext in ("pgm", "png"):
        names = []
        for k, im in enumerate(imgs):
            p = str(tmp_path / f"bg{k}.{ext}")
            write_pgm(p, im) if ext == "pgm" else cv2.imwrite(p, im)
            names.append(p)
        lists[ext] = str(tmp_path / f"bg_{ext}.txt")
        with open(lists[ext], "w") as f:
            f.write("\n".join(names) + "\n")
    want = NegReader(lists["png"], 24, 24).take_batch(40)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    got = NegReader(lists["pgm"], 24, 24).take_batch(40)
    np.testing.assert_array_equal(got, want)
