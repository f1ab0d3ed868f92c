"""The port stands on torch and numpy alone, and its entry points want the card."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "self_attention_tacotron_torch")
FORBIDDEN = ("jax", "flax", "orbax", "self_attention_tacotron_tpu")


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PACKAGE):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call):
            # importlib.import_module("x") / __import__("x") with a literal name
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


def test_the_walk_sees_the_package_and_the_smoke_script():
    names = [os.path.relpath(p, REPO) for p in _sources()]
    assert "chip_smoke.py" in names
    for expected in ("synthesis.py", "convert.py", "hparams.py", "ops/fused_rnn.py",
                     "ops/fused_attention.py", "ops/fused_decode.py", "ops/decode_loop.py",
                     "models/models.py", "models/losses.py", "ops/fused_teacher.py",
                     "training/trainer.py", "training/schedules.py", "tools/flagship.py",
                     "tools/profile_training.py", "models/encoders.py", "models/modules.py",
                     "tools/profile_synthesis.py", "models/self_attention.py",
                     "models/attention.py", "models/decoders.py", "utils/cuda_build.py",
                     "audio/dsp.py", "audio/audio.py", "text/english.py", "text/japanese.py",
                     "text/symbols.py", "data/dataset.py", "data/corpus.py", "data/synthetic.py",
                     "data/ljspeech.py", "data/vctk.py", "data/japanese.py",
                     "data/dataset_factory.py", "utils/tfrecord.py", "training/metrics.py",
                     "train.py", "predict_mel.py", "preprocess.py", "parallel/__init__.py",
                     "parallel/mesh.py", "parallel/shard.py"):
        assert os.path.join("self_attention_tacotron_torch", expected) in names


def test_the_mesh_tests_rank_functions_import_nothing_of_jax():
    # spawned ranks import this module by name, without conftest.py's JAX setup
    path = os.path.join(REPO, "tests", "torch_mesh_workers.py")
    roots = set(_imported_roots(path))
    assert "self_attention_tacotron_torch" in roots
    assert not roots & set(FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_nothing_of_jax():
    code = (
        "import sys\n"
        "import self_attention_tacotron_torch\n"
        "from self_attention_tacotron_torch import convert, synthesis\n"
        "from self_attention_tacotron_torch.models import models\n"
        "from self_attention_tacotron_torch.ops import fused_rnn, fused_attention, decode_loop\n"
        "from self_attention_tacotron_torch.ops import fused_decode, fused_teacher\n"
        "from self_attention_tacotron_torch.models import losses\n"
        "from self_attention_tacotron_torch.training import schedules, trainer\n"
        "from self_attention_tacotron_torch.tools import flagship, profile_synthesis\n"
        "from self_attention_tacotron_torch.tools import profile_training\n"
        "from self_attention_tacotron_torch import audio, text, data\n"
        "from self_attention_tacotron_torch.audio import dsp\n"
        "from self_attention_tacotron_torch.data import corpus, synthetic, dataset_factory\n"
        "from self_attention_tacotron_torch.utils import tfrecord\n"
        "from self_attention_tacotron_torch.training import metrics\n"
        "from self_attention_tacotron_torch import train, predict_mel, preprocess\n"
        "print('MATPLOTLIB', 'matplotlib' in sys.modules, 'tensorboard' in sys.modules)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('LOADED', bad)\n"
        # no kernel is built or bound, and no triton is asked for, by an import
        "from self_attention_tacotron_torch.utils import cuda_build\n"
        "print('BOUND', sorted(cuda_build._libraries), 'triton' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    # matplotlib and TensorBoard are imported where a plot or a scalar is written
    assert "MATPLOTLIB False False" in out.stdout, out.stdout
    assert "BOUND [] False" in out.stdout, out.stdout


def test_kernel_sources_are_cuda_for_sm_90a_and_are_built_into_an_ignored_directory():
    from self_attention_tacotron_torch.utils import cuda_build

    assert {"bigru", "mha_full", "fused_decode", "bigru_bwd", "fused_teacher",
            "bilstm"} <= set(cuda_build.KERNEL_SOURCES)
    for name in cuda_build.KERNEL_SOURCES:
        assert os.path.isfile(cuda_build.source_path(name))
        assert cuda_build.library_path(name).startswith(cuda_build.BUILD_DIR)
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "self_attention_tacotron_torch/build/" in f.read().split()


def test_entry_points_want_the_card_unless_told_otherwise():
    from self_attention_tacotron_torch.hparams import HParams
    from self_attention_tacotron_torch.models.models import (
        TacotronNetwork, tacotron_model_factory,
    )
    from self_attention_tacotron_torch.synthesis import make_predict_fn

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is allowed to work")
    hp = HParams(
        decoder="DualSourceSelfAttentionDecoder", num_symbols=12, embedding_dim=8,
        encoder_prenet_out_units=(8, 8), cbhg_out_units=8, conv_channels=4,
        max_filter_width=2, projection1_out_channels=4, projection2_out_channels=8,
        num_highway=1, self_attention_out_units=8, self_attention_transformer_ffn_units=8,
        decoder_prenet_out_units=(8, 8), attention_out_units=8, attention1_out_units=4,
        attention2_out_units=4, decoder_out_units=8, decoder_self_attention_out_units=8,
        num_mels=4, max_iters=3,
    )
    net = TacotronNetwork(hp)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_predict_fn(net)
    with pytest.raises(RuntimeError, match="CUDA"):
        tacotron_model_factory(hp).network()
    predict = make_predict_fn(net, device="cpu")          # the CPU only when asked for
    out = predict({"source": [[1, 2, 3]], "source_lengths": [3]})
    assert out["mel"].shape == (1, 6, 4) and out["mel"].device.type == "cpu"


def test_a_cuda_tensor_never_reaches_the_plain_version():
    """On a CUDA tensor the wrappers launch the kernel or raise; the module
    gates read the tensor's device, not a global switch."""
    import inspect

    from self_attention_tacotron_torch.ops import (
        fused_attention, fused_decode, fused_rnn, fused_teacher,
    )

    for fn in (fused_rnn.bigru, fused_attention.mha_full, fused_decode.fused_decode,
               fused_rnn.bigru_bwd_carry, fused_teacher.teacher_decode, fused_rnn.bilstm):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src
        assert 'device.type == "cpu"' in src


def test_fused_decode_on_a_device_without_a_kernel_raises():
    from self_attention_tacotron_torch.ops import fused_decode

    packed = fused_decode.PackedDecoder(
        flat=torch.zeros(4, device="meta"), offsets={}, shapes={}, sizes={},
        use_transition_agent=False, zoneout_cell=0.1, zoneout_output=0.1, forget_bias=1.0,
        keep_prob=0.5, ln_eps=1e-6, pe_rate=torch.zeros(4, dtype=torch.float64),
    )
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fused_decode.fused_decode(packed, None, None, 3, 0.5)


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    """Every CUDA source opens with the Pallas kernel it replaces."""
    from self_attention_tacotron_torch.utils import cuda_build

    for name in cuda_build.KERNEL_SOURCES:
        with open(cuda_build.source_path(name)) as f:
            head = f.read(1000)
        assert "Replaces the" in head and "Pallas kernel" in head, name
        assert "self_attention_tacotron_tpu/ops/" in head, name


def test_bilstm_on_a_device_without_a_kernel_raises():
    from self_attention_tacotron_torch.ops import fused_rnn

    params = {"kernel": torch.zeros(12, 16, device="meta"), "bias": torch.zeros(16, device="meta")}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fused_rnn.bilstm(torch.zeros(2, 3, 8, device="meta"), torch.tensor([3, 1]), params,
                         params, hidden=4)


def test_resource_usage_reports_the_compilers_failure_and_leaves_no_library(monkeypatch, tmp_path):
    from self_attention_tacotron_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed on .*fused_decode.cu"):
        cuda_build.resource_usage(cuda_build.source_path("fused_decode"))
    assert os.listdir(tmp_path) == []
