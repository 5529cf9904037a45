"""Benchmark harness, profiler, logger and CLI smoke tests."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestProfiler:
    def test_stats_and_tables(self):
        from volrt.utils.profiler import MIN_SAMPLE_STAT, Profiler

        p = Profiler()
        for i in range(MIN_SAMPLE_STAT):
            p.start("cfg_a", "r0")
            p.stop()
        s = p.stats["cfg_a"]["r0"]
        assert s.samples == MIN_SAMPLE_STAT
        assert s.max_ms >= s.avg_ms > 0.0
        table = p.print_avg()
        assert "cfg_a" in table and "r0" in table

    def test_derived_metrics(self):
        from volrt.utils.profiler import derived_metrics

        m = derived_metrics(10.0, 1000, 50)
        assert m["rays_per_s"] == pytest.approx(1e5)
        assert m["ray_steps_per_s"] == pytest.approx(5e6)


class TestLogger:
    def test_tee_and_file(self, tmp_path, capsys):
        from volrt.utils.logger import Logger

        path = str(tmp_path / "t.log")
        log = Logger(path, mode="w")
        log.log("hello %d", 42)
        log.close()
        text = open(path).read()
        assert "hello 42" in text
        assert "session started" in text
        assert "total runtime" in text

    def test_context_manager_closes(self, tmp_path, capsys):
        from volrt.utils.logger import Logger

        path = str(tmp_path / "t.log")
        with Logger(path, mode="w") as log:
            log.log("inside")
        out = capsys.readouterr().out.splitlines()
        assert out[-1].startswith("session closed")
        assert "total runtime" in open(path).read()
        log.close()  # a second close writes nothing
        assert capsys.readouterr().out == ""

    @pytest.mark.parametrize("argv", [
        ["render", "--synthetic", "8", "-s", "8", "8"],
        ["fit", "--synthetic", "8", "-s", "8", "8", "--steps", "1"]])
    def test_commands_close_their_session(self, argv, tmp_path, capsys):
        """A command's session is closed when ``cli.main`` returns, so a
        caller's own last line stays last on stdout."""
        from volrt import cli

        log = str(tmp_path / "v.log")
        extra = ["-o", str(tmp_path / "o.png")] if argv[0] == "render" else []
        assert cli.main(argv + extra + ["--log", log]) == 0
        assert capsys.readouterr().out.splitlines()[-1].startswith(
            "session closed")
        assert open(log).read().splitlines()[-1].startswith("session closed")


class TestHarness:
    def test_tiny_config_runs(self):
        from volrt.bench.harness import BenchConfig, run_suite
        from volrt.utils.logger import Logger

        prof = run_suite(
            configs=[BenchConfig("tiny", volume_size=16, viewport=32)],
            renderers=(1,),
            frames=2,
            warmup=1,
            logger=Logger(path=None, quiet=True),
        )
        assert "tiny" in prof.stats

    def test_diff_suite_two_configs(self):
        """Two differently-shaped XLA fwd+bwd configs in one process
        (regression: a second outer-jit-of-grad-of-inner-jit trace hit a
        JAX 0.9 CPU executable-lookup bug)."""
        from volrt.bench.harness import run_diff_suite
        from volrt.utils.logger import Logger

        prof = run_diff_suite(
            configs=[(16, 32), (24, 48)], frames=1,
            logger=Logger(path=None, quiet=True))
        assert "diff_16_32" in prof.stats
        assert "diff_24_48" in prof.stats

    def test_default_suite_structure(self):
        from volrt.bench.harness import default_suite

        names = [c.name for c in default_suite()]
        # The reference sweep structure: datasets, toggles, viewport, step.
        assert any(n.startswith("synthetic") for n in names)
        assert {"no_optim", "ert_only", "ert_esl"} <= set(names)
        assert any(n.startswith("viewport") for n in names)
        assert any(n.startswith("ray_step") for n in names)


def run_cli(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "volrt.cli", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


class TestCLI:
    def test_info(self):
        r = run_cli("info")
        assert r.returncode == 0, r.stderr
        info = json.loads(r.stdout)
        assert info["device_count"] >= 1

    def test_render_png(self, tmp_path):
        out = str(tmp_path / "out.png")
        log = str(tmp_path / "v.log")
        r = run_cli(
            "render", "--synthetic", "16", "-r", "1", "-s", "32", "32",
            "-o", out, "--log", log,
        )
        assert r.returncode == 0, r.stderr
        from volrt.viz import read_png

        img = read_png(out)
        assert img.shape == (32, 32, 4)
        assert (img[..., :3].sum(axis=-1) > 0).any(), "all-black render"

    def test_render_pvm_file(self, tmp_path, pvm_path):
        # Reference Bucky when present, else the committed DDS asset —
        # the full file->decode->render->PNG pipeline always runs.
        out = str(tmp_path / "bucky.png")
        r = run_cli(
            "render", "-f", pvm_path, "-r", "1", "-s", "48", "48",
            "-o", out, "--log", str(tmp_path / "v.log"),
        )
        assert r.returncode == 0, r.stderr
        from volrt.viz import read_png

        img = read_png(out)
        assert (img[..., :3].sum(axis=-1) > 0).any()


class TestCLIExtras:
    def test_orbit_frames(self, tmp_path):
        out = str(tmp_path / "orb.png")
        r = run_cli(
            "render", "--synthetic", "16", "-r", "1", "-s", "24", "24",
            "--orbit", "3", "-o", out, "--log", str(tmp_path / "v.log"),
        )
        assert r.returncode == 0, r.stderr
        for i in range(3):
            assert os.path.exists(str(tmp_path / f"orb_{i:04d}.png"))

    def test_tf_file_roundtrip(self, tmp_path):
        import jax.numpy as jnp
        import numpy as np

        from volrt.core.tf import default_transfer_fn, load_tf, save_tf

        path = str(tmp_path / "tf.npy")
        tf = default_transfer_fn()
        save_tf(path, tf)
        back = load_tf(path)
        np.testing.assert_array_equal(np.asarray(tf), np.asarray(back))

        out = str(tmp_path / "o.png")
        r = run_cli(
            "render", "--synthetic", "16", "-r", "1", "-s", "24", "24",
            "--tf", path, "-o", out, "--log", str(tmp_path / "v.log"),
        )
        assert r.returncode == 0, r.stderr


class TestBenchFileConfig:
    def test_render_background_composite(self, tmp_path):
        """--background composites over the reference's gray backdrop
        (empty pixels become the clear color; output is RGB)."""
        out = str(tmp_path / "bg.png")
        r = run_cli(
            "render", "--synthetic", "16", "-r", "1", "-s", "32", "32",
            "--background", "0.25", "-o", out,
            "--log", str(tmp_path / "v.log"),
        )
        assert r.returncode == 0, r.stderr
        from volrt.viz import read_png

        img = read_png(out)
        assert img.shape == (32, 32, 3)
        corners = img[[0, 0, -1, -1], [0, -1, 0, -1]]
        assert (np.abs(corners.astype(int) - 64) <= 1).all()

    def test_fit_dist_rays(self, tmp_path):
        """fit --dist rays: the CLI trains over all local devices with
        pixel-row data parallelism (the jit-sharded XLA step)."""
        log = str(tmp_path / "fit.log")
        r = run_cli(
            "fit", "--synthetic", "8", "--steps", "1",
            "--dist", "rays", "--log", log, timeout=560,
        )
        assert r.returncode == 0, r.stderr
        txt = open(log).read()
        assert "dist=rays" in txt
        assert "fit step 0" in txt

    def test_pvm_file_driven_config(self, tmp_path):
        """bench -f <pvm>: file-driven dataset configs (the reference
        loads seven named PVM datasets, VolR.cpp:255-268)."""
        import numpy as np

        from tests.conftest import synthetic_volume
        from volrt.bench.harness import default_suite, run_suite
        from volrt.io.pvm import write_pvm

        path = str(tmp_path / "tiny.pvm")
        write_pvm(path, synthetic_volume(8))
        cfgs = [c for c in default_suite(small=True, files=[path])
                if c.file]
        assert cfgs and cfgs[0].name == "tiny"
        cfgs[0].viewport = 16
        prof = run_suite(configs=cfgs, renderers=(1,), frames=2)
        assert "tiny" in prof.stats


class TestXlaBench:
    def test_bench_diff_step(self):
        from volrt.bench.harness import bench_diff_step

        m = bench_diff_step(volume_size=12, viewport=16, iters=1)
        assert m["ms"] > 0 and np.isfinite(m["loss"]) and m["loss"] > 0
        assert m["ray_steps_per_s"] == pytest.approx(
            m["rays_per_s"] * int(2.0 / (2.0 / 12 - 2.0 / 144)))

    @pytest.mark.parametrize("shading,esl", [
        (None, False), ("diffuse", False), ("phong", True)])
    def test_bench_fwd_step(self, shading, esl):
        from volrt.bench.harness import bench_fwd_step

        m = bench_fwd_step(volume_size=12, viewport=16, iters=1,
                           shading=shading, esl=esl)
        assert m["ms"] > 0 and m["rays_per_s"] == pytest.approx(
            256 / (m["ms"] / 1e3))

    def test_oom_config_is_skipped(self, monkeypatch):
        from volrt.bench import harness
        from volrt.utils.logger import Logger

        def oom(rc):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        monkeypatch.setattr("volrt.renderers.batched.render_float", oom)
        prof = harness.run_suite(
            configs=[harness.BenchConfig("tiny", 16, 32)], renderers=(1,),
            frames=2, logger=Logger(path=None, quiet=True))
        assert "tiny" not in prof.stats

    def test_other_failures_raise(self, monkeypatch):
        from volrt.bench import harness
        from volrt.utils.logger import Logger

        def broken(rc):
            raise ValueError("not an OOM")

        monkeypatch.setattr("volrt.renderers.batched.render_float", broken)
        with pytest.raises(ValueError, match="not an OOM"):
            harness.run_suite(
                configs=[harness.BenchConfig("tiny", 16, 32)],
                renderers=(1,), frames=2,
                logger=Logger(path=None, quiet=True))


class TestRendererLadder:
    def test_two_rungs(self):
        from volrt.constants import RENDERER_COUNT
        from volrt.renderers import get_renderer, renderer_name

        assert RENDERER_COUNT == 2
        assert [renderer_name(i) for i in range(RENDERER_COUNT)] == [
            "jax-golden", "xla-batched"]
        with pytest.raises(ValueError, match="out of range"):
            get_renderer(RENDERER_COUNT)

    def test_cli_default_is_rung1_trilinear(self, tmp_path):
        """`volrt render` with no -r draws rung 1 with trilinear sampling
        (the old default rung was trilinear too)."""
        from volrt import cli
        from volrt.core import sampling
        from volrt.renderers import batched
        from volrt.viz import read_png

        argv = ["render", "--synthetic", "16", "-s", "24", "20",
                "-o", str(tmp_path / "d.png"),
                "--log", str(tmp_path / "v.log")]
        args = cli.build_parser().parse_args(argv)
        assert args.renderer == 1 and args.interpolation == "trilinear"
        assert cli.main(argv) == 0
        want = np.asarray(sampling.write_color(
            batched.render_float(cli._make_rc(args))))
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "d.png")), want[::-1])

    def test_oom_fallback_reraises_other_errors(self, synth32):
        from volrt.core.types import Volume, make_raycaster
        from volrt.utils.errors import render_with_oom_fallback

        rc = make_raycaster(Volume.from_numpy(synth32))

        def broken(sub_rc):
            raise ValueError("shape mismatch")

        with pytest.raises(ValueError, match="shape mismatch"):
            render_with_oom_fallback(broken, rc)
