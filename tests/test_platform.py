"""The platform decision (detect/backend.py), the compile-cache location
and the chip smoke test's refusal to run off the GPU."""

import os
import subprocess
import sys

import pytest

from cascadeclassifier_tpu.detect.backend import auto_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engine_decision_gpu():
    # stump Haar, LBP / deep Haar, HOG-like (neither)
    assert auto_engine(True, True, "gpu") == "fused"
    assert auto_engine(True, False, "gpu") == "fused"
    assert auto_engine(False, False, "gpu") == "xla"


def test_engine_decision_cpu():
    assert auto_engine(True, True, "cpu") == "compact"
    assert auto_engine(True, False, "cpu") == "xla"
    assert auto_engine(False, False, "cpu") == "xla"
    # the default reads the running backend (the CPU under this suite)
    assert auto_engine(True, True) == "compact"


def _cache_probe(env):
    """Compile one fresh program in a child process; return the cache
    directory JAX used and the files it holds afterwards."""
    code = (
        "import os, time, jax, jax.numpy as jnp, cascadeclassifier_tpu; "
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0); "
        "c = time.time_ns() % 1000003; "
        "jax.jit(lambda x: x * c + 1)(jnp.ones(3)).block_until_ready(); "
        "d = jax.config.jax_compilation_cache_dir; "
        "print(d); print(len(os.listdir(d)))"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, check=True,
    ).stdout.split()
    return out[-2], int(out[-1])


def test_compile_cache_follows_env_variable(tmp_path):
    d = str(tmp_path / "jaxcache")
    used, n = _cache_probe({"JAX_COMPILATION_CACHE_DIR": d})
    assert used == d and n >= 1 and len(os.listdir(d)) == n


def test_compile_cache_defaults_into_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("import os, cascadeclassifier_tpu as c, jax; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(c.compile_cache_dir())")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env={**env, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
        check=True,
    ).stdout.split()
    want = os.path.join(REPO, ".jax_cache")
    assert out[-2] == out[-1] == want


def test_chip_smoke_refuses_cpu():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stdout + r.stderr


@pytest.mark.parametrize("cascade", ["haar", "lbp"])
def test_xla_engine_matches_oracle_golden(cascade):
    """The plain XLA engine (exact f64 stage sums) reproduces the OpenCV
    C++ runtime's committed rects on the 640x480 golden frame, raw
    (minNeighbors 0) and grouped (3)."""
    import numpy as np

    from cascadeclassifier_tpu.data import synth
    from cascadeclassifier_tpu.detect.detector import TPUDetector
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    det = TPUDetector(
        read_cascade_xml(synth.GOLDEN_CASCADES[cascade]), exact=True,
        engine="xla",
    )
    frame = synth.golden_frame("640x480")
    for mn in (0, 3):
        got = det.detect_multi_scale(frame, synth.GOLDEN_SCALE, mn)
        want = synth.read_golden(cascade, "640x480", mn)
        assert sorted(map(tuple, np.asarray(got).tolist())) == sorted(
            map(tuple, want.tolist())
        )


def test_generator_fires_raw_windows():
    """The seeded frames are reproducible and make parity non-vacuous:
    the OpenCV runtime fires hundreds of raw windows on each golden
    frame with both cascades, and grouping still leaves several."""
    import numpy as np

    from cascadeclassifier_tpu.data import synth

    a = synth.golden_frame("640x480")
    assert np.array_equal(a, synth.golden_frame("640x480"))
    assert not np.array_equal(a, synth.face_blob_image(640, 480, n=8, seed=12))
    assert np.array_equal(synth.golden_frame("1920x1080"), synth.bench_frame(0))
    for cascade in synth.GOLDEN_CASCADES:
        for key in synth.GOLDEN_FRAMES:
            assert len(synth.read_golden(cascade, key, 0)) >= 100
            assert len(synth.read_golden(cascade, key, 3)) >= 5
