"""chip_smoke.py's phases at toy size on the CPU, its refusal to run without
a GPU, bench.py's refusal, and the compile-cache helper."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from volrt.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env["PYTHONPATH"] = REPO if cwd == REPO else ""
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=cwd)


def _has_result(stdout):
    return any(line.startswith("{") and '"ok"' in line
               for line in stdout.splitlines())


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    return chip_smoke.phase_render(16, 32, str(tmp_path_factory.mktemp("r")))


class TestPhases:
    def test_render(self, rendered):
        rc, img = rendered
        assert img.shape == (32, 32, 4)
        assert np.isfinite(img).all() and img[..., 3].max() > 0
        assert rc.interpolation == "trilinear"

    def test_fit_loss_falls(self, tmp_path):
        losses = chip_smoke.phase_fit(16, 32, 3, str(tmp_path))
        assert len(losses) == 3 and losses[-1] < losses[0]

    def test_parity(self, rendered):
        rc, img = rendered
        out = chip_smoke.phase_parity(rc, img, band_rows=8)
        assert out["fwd_max_abs"] == 0.0
        assert out["dev_density"] == out["cpu_density"]

    def test_parity_rejects_a_wrong_image(self, rendered):
        rc, img = rendered
        bad = img.copy()
        bad[16, 16, 0] += 0.01
        with pytest.raises(RuntimeError, match="parity"):
            chip_smoke.phase_parity(rc, bad, band_rows=8)

    def test_four_devices_match_one(self):
        out = chip_smoke.phase_four(16, 32, 4)
        for mode in ("rays", "volume"):
            assert out[mode]["loss_rel"] <= chip_smoke.FOUR_LOSS_RTOL

    def test_fit_losses_parsed_from_log(self, tmp_path):
        log = tmp_path / "fit.log"
        log.write_text("session started\nfit step 0: loss 0.5\n"
                       "fit step 1: loss 0.25\nfinal loss 0.25\n")
        assert chip_smoke._fit_losses(str(log)) == [0.5, 0.25]

    @pytest.mark.parametrize("err,ref,ok", [
        (1e-6, 1e-6, True), (2e-2, 1e-2, True), (3e-2, 1e-2, False),
        (2e-5, 0.0, False)])
    def test_no_worse_rule(self, err, ref, ok):
        assert chip_smoke.no_worse(err, ref) is ok


class TestRefusesWithoutGpu:
    def test_main_returns_nonzero(self, capsys):
        assert chip_smoke.main([]) != 0
        assert not _has_result(capsys.readouterr().out)

    def test_script_exits_nonzero(self):
        r = _run(["chip_smoke.py"])
        assert r.returncode != 0 and not _has_result(r.stdout)
        assert "no GPU" in r.stderr

    def test_script_alone_exits_nonzero(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _run(["chip_smoke.py"], cwd=str(tmp_path))
        assert r.returncode != 0 and not _has_result(r.stdout)

    def test_bench_exits_nonzero(self):
        r = _run(["bench.py"])
        assert r.returncode != 0 and r.stdout.strip() == ""
        assert "needs a GPU" in r.stderr


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch):
        monkeypatch.setattr(jax.config, "update", pytest.fail)
        env = {"JAX_COMPILATION_CACHE_DIR": "/some/dir"}
        assert compile_cache.setup_compile_cache(env) == "/some/dir"

    def test_unset_uses_repo_cache(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = compile_cache.setup_compile_cache({"JAX_PLATFORMS": "cuda"})
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_cpu_runs_keep_no_cache(self, monkeypatch):
        monkeypatch.setattr(jax.config, "update", pytest.fail)
        assert compile_cache.setup_compile_cache(
            {"JAX_PLATFORMS": "cpu"}) is None

    def test_gpu_with_cpu_fallback_keeps_the_cache(self, monkeypatch):
        monkeypatch.setattr(jax.config, "update", lambda *a: None)
        assert compile_cache.setup_compile_cache(
            {"JAX_PLATFORMS": "cuda,cpu"}) == compile_cache.REPO_CACHE_DIR

    def test_cli_writes_cache_where_env_says(self, tmp_path):
        cache = tmp_path / "cache"
        repo_cache = os.path.join(REPO, ".jax_cache")
        before = (sorted(os.listdir(repo_cache))
                  if os.path.isdir(repo_cache) else None)
        r = _run(["-m", "volrt.cli", "render", "--synthetic", "8",
                  "-s", "8", "8", "-o", str(tmp_path / "o.png"),
                  "--log", str(tmp_path / "v.log")],
                 env_extra={"JAX_COMPILATION_CACHE_DIR": str(cache),
                            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS":
                            "0"})
        assert r.returncode == 0, r.stderr
        assert cache.is_dir() and os.listdir(cache)
        after = (sorted(os.listdir(repo_cache))
                 if os.path.isdir(repo_cache) else None)
        assert after == before


def test_process_last_line_is_the_result_json():
    """Run as a process with the GPU check, the parity and the gpu tests
    stubbed and the CLI phases real at toy size: nothing the CLI leaves
    behind (such as a session closing at exit) prints after the result."""
    code = (
        "import sys, jax, chip_smoke as c\n"
        "c.require_gpu = lambda: jax.devices()[0]\n"
        "c.card_line = lambda: 'card, 700.00 W'\n"
        "c.SIZE, c.VIEWPORT = 16, 32\n"
        "c.phase_parity = lambda *a: {}\n"
        "c.phase_gpu_tests = lambda: 1\n"
        "sys.exit(c.main([]))\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert json.loads(last)["ok"] is True, r.stdout


def test_last_line_is_the_result_json(monkeypatch, capsys, tmp_path):
    """With every phase stubbed, main's last stdout line is exactly the
    result object, naming the device."""
    dev = jax.devices()[0]
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda: dev)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    monkeypatch.setattr(chip_smoke, "phase_render",
                        lambda *a: (None, None))
    monkeypatch.setattr(chip_smoke, "phase_fit", lambda *a: [1.0, 0.5])
    monkeypatch.setattr(chip_smoke, "phase_parity", lambda *a: {})
    monkeypatch.setattr(chip_smoke, "phase_gpu_tests", lambda: 1)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}
