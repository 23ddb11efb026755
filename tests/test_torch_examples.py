"""The port's chain examples (``examples/torch_*.py``) against the originals
they port, at tolerance 0.

Each port example runs with ``--device cpu`` in a subprocess of its own and
must exit 0; the three originals run under ``JAX_PLATFORMS=cpu`` in ONE
reference subprocess, at the same time.  Every line the two print must be
the same, but the timings (the scraped latency quantiles) and the incident
dump's file name (it carries a process id), which are masked: the
invariants, the learned (dst, prob) pairs, ``n_needed``, the live edges
before and after the decay, the hit rates and items shown, the paging
rates, restore steps and replay counts, retry and poison counters, the
scraped per-bucket traffic and the "match" lines.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "recommender_sessions", "telecom_paging")
DEFAULT = "telecom_paging on the default device"

_REFERENCE = textwrap.dedent(
    """
    import contextlib, io, runpy, sys
    out_dir = sys.argv[1]
    for name in sys.argv[2:]:
        buf = io.StringIO()
        sys.argv = [name]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(name, run_name="__main__")
        base = name.rsplit("/", 1)[-1]
        with open(f"{out_dir}/{base}.txt", "w") as f:
            f.write(buf.getvalue())
    print("REFERENCE-EXAMPLES-OK")
    """)

MASKS = (
    (re.compile(r'(mcq_engine_\w+_seconds\{quantile="[0-9.]+"\}) \S+'),
     r"\1 <seconds>"),
    (re.compile(r"incident_(\d+)_\d+\.json"), r"incident_\1_<pid>.json"),
)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def _masked(text):
    for pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    return text.splitlines()


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """``{example: (the original's stdout, the port's run)}``: the reference
    subprocess starts first, the three port examples beside it, and one on
    its default device (``DEFAULT``, no original)."""
    out_dir = tmp_path_factory.mktemp("examples")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out_dir),
         *(str(ROOT / "examples" / f"{name}.py") for name in EXAMPLES)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    commands = {name: [str(ROOT / "examples" / f"torch_{name}.py"),
                       "--device", "cpu"] for name in EXAMPLES}
    commands[DEFAULT] = [str(ROOT / "examples" / "torch_telecom_paging.py")]
    ports = {name: subprocess.Popen(
        [sys.executable, *cmd], env=_env(OMP_NUM_THREADS="1"), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, cmd in commands.items()}
    runs = {name: (*proc.communicate(timeout=300), proc.returncode)
            for name, proc in ports.items()}
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0 and "REFERENCE-EXAMPLES-OK" in out, err[-3000:]
    return {name: ((out_dir / f"{name}.py.txt").read_text()
                   if name in EXAMPLES else None, run)
            for name, run in runs.items()}


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_prints_what_the_original_prints(outputs, name):
    want, (got, err, rc) = outputs[name]
    assert rc == 0, err[-3000:]
    want, got = _masked(want), _masked(got)
    assert len(want) >= 5 and got == want


def test_port_example_needs_a_gpu_unless_told_cpu(outputs):
    """The default device is the GPU, with no fallback: here, with no CUDA
    device, the example exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (out, err, rc) = outputs[DEFAULT]
    assert rc != 0 and out == "" and "no CUDA device" in err
