"""repro_torch stands alone: no jax, no repro, and no silent CPU fallback.

The port must run on a host without JAX, so importing every one of its
modules must pull in neither `jax` nor any module of the reference package.
Its entry points default to device="cuda" and must raise — not quietly run
on the CPU — when no card is present (this host has none; the tests that
need one are in tests/test_torch_cuda.py).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as lm_configs
from repro_torch import device as device_lib
from repro_torch import interop
from repro_torch.configs import equalizer_ht as HT
from repro_torch.core import autotune
from repro_torch.core import equalizer as teq
from repro_torch.core import qat as tqat
from repro_torch.core.engine import EqualizerEngine
from repro_torch.data import pipeline as lm_data
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.models import transformer as lm_transformer
from repro_torch.models import xlstm as lm_xlstm
from repro_torch.examples import quickstart, stream_equalizer
from repro_torch.serve import AsyncServeRuntime, ServeRuntime

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def test_port_imports_no_jax_and_no_reference_module():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "repro" or k.startswith("repro."))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 20, names
    """)
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


LM_MODULES = ("repro_torch.models.common", "repro_torch.models.attention",
              "repro_torch.models.mlp", "repro_torch.models.transformer",
              "repro_torch.models.registry", "repro_torch.parallel.sharding",
              "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.shapes",
              "repro_torch.kernels.flash_attn.flash_attn",
              "repro_torch.kernels.flash_attn.ops",
              "repro_torch.kernels.flash_attn.ref",
              "repro_torch.launch.steps", "repro_torch.launch.serve")


@pytest.mark.parametrize("name", LM_MODULES)
def test_lm_serving_modules_import_without_jax(name):
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({name!r})
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


TRAIN_MODULES = ("repro_torch.launch.train", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
                 "repro_torch.runtime.fault")


@pytest.mark.parametrize("name", TRAIN_MODULES)
def test_lm_training_modules_import_without_jax(name):
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({name!r})
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


SSM_MODULES = ("repro_torch.models.xlstm", "repro_torch.configs.xlstm_125m",
               "repro_torch.kernels.slstm", "repro_torch.kernels.slstm.slstm",
               "repro_torch.kernels.slstm.ops",
               "repro_torch.kernels.slstm.ref")


@pytest.mark.parametrize("name", SSM_MODULES)
def test_xlstm_serving_modules_import_without_jax(name):
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({name!r})
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


STREAMING_MODULES = ("repro_torch.serve", "repro_torch.serve.runtime",
                     "repro_torch.serve.loadgen", "repro_torch.obs",
                     "repro_torch.obs.link", "repro_torch.obs.slo",
                     "repro_torch.obs.report",
                     "repro_torch.core.stream_partition",
                     "repro_torch.core.timing_model",
                     "repro_torch.core.seqlen_opt",
                     "repro_torch.examples.quickstart",
                     "repro_torch.examples.stream_equalizer")


@pytest.mark.parametrize("name", STREAMING_MODULES)
def test_streaming_modules_import_without_jax(name):
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({name!r})
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.")
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
        assert not any(k.startswith("repro_torch.serve.fleet")
                       for k in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _folded():
    p = teq.init(torch.Generator().manual_seed(0), HT.CNN, device="cpu")
    return teq.folded_weights(
        teq.fold_bn(p, teq.init_bn_state(HT.CNN, device="cpu"), HT.CNN))


@pytest.mark.parametrize("entry", [
    lambda: device_lib.resolve_device(),
    lambda: device_lib.resolve_device(None),
    lambda: interop.to_torch({"w": np.zeros(3, np.float32)}),
    lambda: teq.init(torch.Generator().manual_seed(0), HT.CNN),
    lambda: teq.init_bn_state(HT.CNN),
    lambda: tqat.init_qparams(["layer0"], tqat.QATConfig()),
    lambda: EqualizerEngine(cfg=HT.CNN, weights=_folded()),
    lambda: autotune.platform_key("cuda"),
    lambda: ServeRuntime(),
    lambda: AsyncServeRuntime(),
    lambda: quickstart.main([]),
    lambda: stream_equalizer.main([]),
    lambda: lm_serve.serve_session(
        lm_configs.get_config("qwen3-0.6b", True, tp=1), 1, 4, 8),
    lambda: lm_serve.main(["--batch", "1", "--prompt-len", "4", "--gen",
                           "1"]),
    lambda: lm_transformer.init(torch.Generator(),
                                lm_configs.get_config("qwen3-0.6b", True)),
    lambda: lm_transformer.init_cache(
        lm_configs.get_config("qwen3-0.6b", True), 1, 8),
    lambda: lm_serve.serve_session(
        lm_configs.get_config("xlstm-125m", True, tp=1), 1, 4, 8),
    lambda: lm_serve.main(["--arch", "xlstm-125m", "--batch", "1",
                           "--prompt-len", "4", "--gen", "1"]),
    lambda: lm_xlstm.init(torch.Generator(),
                          lm_configs.get_config("xlstm-125m", True)),
    lambda: lm_xlstm.init_states(lm_configs.get_config("xlstm-125m", True),
                                 1),
])
def test_entry_point_without_device_raises_without_card(monkeypatch, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch,
                                                         tmp_path):
    from repro_torch.kernels import _build
    from repro_torch.kernels.cnn_eq import cnn_eq as kern
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kern.build()


def test_cpu_is_explicit_and_other_devices_are_refused():
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device_lib.resolve_device("meta")


def test_fp32_exact_turns_tf32_off_and_restores():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with device_lib.fp32_exact():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_interop_round_trips_trees_and_bf16():
    import ml_dtypes
    tree = {"conv": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "b": np.float32(1.5)}],
            "qat": {"layer0": {"w_int": 2.0}},
            "folded": ((np.ones((2, 1, 3), np.int8), None),),
            "bf": np.array([1.0078125, -3.5], dtype=ml_dtypes.bfloat16)}
    t = interop.to_torch(tree, device="cpu")
    assert t["conv"][0]["w"].dtype == torch.float32
    assert t["conv"][0]["b"].dim() == 0
    assert t["qat"]["layer0"]["w_int"] == 2.0          # python leaf kept
    assert t["folded"][0][0].dtype == torch.int8
    assert t["folded"][0][1] is None
    assert t["bf"].dtype == torch.bfloat16
    back = interop.to_numpy(t)
    np.testing.assert_array_equal(back["conv"][0]["w"], tree["conv"][0]["w"])
    np.testing.assert_array_equal(back["folded"][0][0], tree["folded"][0][0])
    assert back["bf"].dtype == np.float32
    np.testing.assert_array_equal(back["bf"], tree["bf"].astype(np.float32))


def _tiny_state():
    from repro_torch.optim import AdamW
    params = {"w": torch.zeros(2)}
    return params, AdamW().init(params)


@pytest.mark.parametrize("entry", [
    lambda tmp: lm_train.build(lm_configs.get_config("qwen3-0.6b", True),
                               3e-4, 1),
    lambda tmp: lm_train.main(["--steps", "1", "--batch", "2", "--seq",
                               "8", "--ckpt-dir", str(tmp)]),
    lambda tmp: lm_train.run(["--steps", "1", "--batch", "2", "--seq", "8",
                              "--ckpt-dir", str(tmp)]),
    lambda tmp: lm_data.lm_batches(lm_data.PipelineConfig(8, 2),
                                   lm_configs.get_config("qwen3-0.6b", True)),
    lambda tmp: _saved(tmp).restore(_tiny_state(), device="cuda"),
], ids=["build", "main", "run", "lm_batches", "restore"])
def test_training_entry_points_raise_without_card(monkeypatch, tmp_path,
                                                  entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry(tmp_path)


def _saved(tmp):
    from repro_torch.checkpoint import CheckpointManager
    ckpt = CheckpointManager(str(tmp / "ckpt"))
    ckpt.save(1, _tiny_state())
    return ckpt


def test_flash_backward_build_raises_without_compiler(monkeypatch,
                                                      tmp_path):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import flash_attn as fa
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.build_bwd()


def test_slstm_build_raises_without_compiler(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm import slstm as kern
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kern.build()
