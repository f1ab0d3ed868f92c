"""Nothing under port_bench loads JAX, flax, orbax or the JAX package; the
reference loads nothing of the program either. Judged in a fresh interpreter
by whole top-level module names."""

import glob
import os
import subprocess
import sys

from conftest import ROOT

HERE = os.path.join(ROOT, "port_bench")
BANNED = {"jax", "jaxlib", "flax", "orbax", "self_attention_tacotron_tpu"}


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    return {m.split(".")[0] for m in out.stdout.split()}


def _readers():
    names = []
    for folder in ("metrics", "end_to_end"):
        for path in glob.glob(os.path.join(HERE, folder, "*.py")):
            name = os.path.basename(path)[:-3]
            if name != "__init__":
                names.append((folder, name))
    return names


def test_the_benchmark_loads_no_jax():
    readers = "; ".join(f"harness.load_reader({f!r}, {n!r})" for f, n in _readers())
    loaded = _loaded_after(
        "import port_bench, port_bench.run, port_bench.harness as harness, port_bench.check, "
        "port_bench.counts.fused_decode, port_bench.counts.fused_teacher, "
        "port_bench.traffic.synthesis, port_bench.traffic.training, "
        "port_bench.drivers.synthesis, port_bench.drivers.training; " + readers)
    assert not loaded & BANNED, sorted(loaded & BANNED)
    assert "self_attention_tacotron_torch" not in BANNED and "self_attention_tacotron_tpu" in BANNED


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import port_bench.reference.model, port_bench.reference.weights, "
                           "port_bench.reference.tacotron")
    assert not loaded & (BANNED | {"self_attention_tacotron_torch"}), sorted(loaded)


def test_banned_names_are_whole_top_level_names():
    from port_bench import harness

    sys.modules.setdefault("self_attention_tacotron_torch_like", sys)
    try:
        assert "self_attention_tacotron_torch_like" not in harness.banned_modules()
    finally:
        del sys.modules["self_attention_tacotron_torch_like"]
