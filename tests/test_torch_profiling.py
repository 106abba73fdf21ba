"""Per-pass profiling (runtime/profiling.py), --profile and
targetRenderingTime in the port, on the CPU, on 16x16 Cornell jobs.

* run_photon_fam(profile=True) reports the passes of the JAX package's
  names, gbuffer, light_trace, vpl_gather (lvc_gather for lvcphotonfam)
  and photon_splat, each with calls == 2 for two frames (the warm-up is
  not timed), as tests/test_checkpoint_cli.py checks for the JAX package;
  the profiled images equal the unprofiled ones bit for bit.
* EVPLP_PROFILE=1 turns the timer on when profile is not given.
* targetRenderingTime is parsed as the JAX package parses it (default
  -1); for the frame times the JAX loop measures (under a clock that
  steps 250 ms a call), light_path_suggestion gives the JAX loop's very
  line, for a VPL and a PM block; the port's loop prints its line after
  each progress line.
* `python -m evplp_tpu_torch --device cpu --profile` prints the passes
  with the stats; a pt config drops --profile, as the JAX CLI does.
* device_trace records a CPU frame into a Chrome trace."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from evplp_tpu.runtime import loop as jax_loop
from evplp_tpu.scene.config import load_config as jax_load_config
from evplp_tpu_torch.integrators import photon_fam
from evplp_tpu_torch.runtime import loop
from evplp_tpu_torch.runtime.profiling import PassTimer, device_trace
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.export import write_cornell_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = dict(rngOffset=0, numMaxIteration=2, timeLimitMs=-1.0,
             frameMode="accumulate", useJitter=True, useStat=False,
             numLightPaths=128, numVplLightPaths=8, numMaxBounces=2,
             radiusPercentage=0.05, combinedFilename="",
             weightedPhotonFilename="", weightedVplFilename="")
GATHER = {"photonfam": "vpl_gather", "lvcphotonfam": "lvc_gather"}


@pytest.mark.parametrize("technique", sorted(GATHER))
def test_profile_reports_every_pass(tmp_path, technique):
    path = write_cornell_config(str(tmp_path), BLOCK, technique, res=16,
                                name="p")
    plain = loop.run_photon_fam(load_config(path, device="cpu"))
    res = loop.run_photon_fam(load_config(path, device="cpu"), profile=True)
    passes = res.stats["passes"]
    names = ("gbuffer", "light_trace", GATHER[technique], "photon_splat")
    assert sorted(passes) == sorted(names)
    for name in names:
        assert passes[name]["calls"] == 2
        assert passes[name]["ms_total"] >= passes[name]["ms_avg"] > 0.0
    assert "passes" not in plain.stats
    assert plain.images["combined"].max() > 0.0
    for k in ("combined", "weighted_vpl", "weighted_photon"):
        np.testing.assert_array_equal(res.images[k], plain.images[k])


def test_profile_env_default(monkeypatch):
    monkeypatch.setenv("EVPLP_PROFILE", "1")
    assert PassTimer().enabled
    monkeypatch.setenv("EVPLP_PROFILE", "0")
    timer = PassTimer()
    assert not timer.enabled
    assert timer.time_call("x", lambda a: a + 1, 1) == 2
    assert timer.report() == {}
    on = PassTimer(enabled=True)
    with on.span("block"):
        pass
    assert on.report()["block"]["calls"] == 1


class _StepClock:
    """perf_counter advancing 250 ms a call: frame times exact in the
    loops' printed milliseconds."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t

    def time(self):
        return self.t


def _suggestions(out: str) -> list:
    """(frame_ms, the line after it) for each progress line of a loop's
    output, frame_ms from the printed elapsed times."""
    lines = out.splitlines()
    pairs, prev = [], 0.0
    for i, line in enumerate(lines):
        m = re.match(r"numIter: \d+ \|.*\| time: ([0-9.]+)ms", line)
        if m:
            now = float(m.group(1))
            pairs.append((now - prev, lines[i + 1]))
            prev = now
    return pairs


@pytest.mark.parametrize("block", [
    dict(BLOCK, targetRenderingTime=120.0),
    dict(BLOCK, targetRenderingTime=40.0, numVplLightPaths=0),
], ids=["vpl", "pm"])
def test_target_rendering_time_line(tmp_path, monkeypatch, capsys, block):
    block = dict(block, numMaxIteration=3)
    path = write_cornell_config(str(tmp_path), block, "photonfam", res=16,
                                name="t")
    job = load_config(path, device="cpu")
    jax_job = jax_load_config(path)
    assert job.params.target_rendering_time == \
        jax_job.params.target_rendering_time == block["targetRenderingTime"]
    no_target = write_cornell_config(str(tmp_path), BLOCK, "photonfam",
                                     res=16, name="n")
    assert load_config(no_target, device="cpu").params \
        .target_rendering_time == -1.0
    assert loop.light_path_suggestion(
        load_config(no_target, device="cpu").params, 10.0) is None

    # the loops' frames do nothing here: only their clocks and prints run
    monkeypatch.setattr(jax_loop, "photon_fam_frame",
                        lambda scene, cfg, state, *a, **k: state)
    monkeypatch.setattr(jax_loop, "time", _StepClock())
    capsys.readouterr()
    jax_loop.run_photon_fam(jax_job, progress_every=1)
    jax_pairs = _suggestions(capsys.readouterr().out)
    assert len(jax_pairs) == 3
    for frame_ms, line in jax_pairs:
        assert loop.light_path_suggestion(job.params, frame_ms) == line

    monkeypatch.setattr(loop, "photon_fam_frame",
                        lambda scene, cfg, state, *a, **k: state)
    monkeypatch.setattr(loop, "time", _StepClock())
    loop.run_photon_fam(job, progress_every=1)
    port_pairs = _suggestions(capsys.readouterr().out)
    assert len(port_pairs) == 3
    for frame_ms, line in port_pairs:
        assert loop.light_path_suggestion(job.params, frame_ms) == line
    assert port_pairs[0][1].startswith(
        "change number of samples" if block["numVplLightPaths"]
        else "Nb light paths")


def test_cli_profile(tmp_path):
    path = write_cornell_config(str(tmp_path), dict(BLOCK, numMaxIteration=1),
                                "photonfam", res=8, name="cli")
    pt = write_cornell_config(str(tmp_path), dict(
        rngOffset=0, numMaxIteration=1, timeLimitMs=-1.0, useStat=False,
        numMaxBounces=1, outputFilename=""), "pt", res=8, name="clipt")
    outs = []
    for cfg in (path, pt):
        proc = subprocess.run(
            [sys.executable, "-m", "evplp_tpu_torch", cfg, "--device", "cpu",
             "--profile"], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout[proc.stdout.index("{"):]))
    passes = outs[0]["passes"]
    assert sorted(passes) == ["gbuffer", "light_trace", "photon_splat",
                              "vpl_gather"]
    assert all(v["calls"] == 1 for v in passes.values())
    assert outs[1]["numIterations"] == 1 and "passes" not in outs[1]


def test_device_trace_records_a_frame(tmp_path):
    path = write_cornell_config(str(tmp_path), BLOCK, "photonfam", res=8,
                                name="tr")
    job = load_config(path, device="cpu")
    cfg = loop._frame_config(job)
    from evplp_tpu_torch.core.sampling import iteration_key
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as prof:
        photon_fam.photon_fam_frame(job.scene, cfg,
                                    photon_fam.init_state(cfg, "cpu"),
                                    iteration_key(0, 0, "cpu"), 0.05, 1.0,
                                    1.0)
    assert os.path.getsize(os.path.join(log_dir, "trace.json")) > 0
    assert len(prof.key_averages()) > 0
