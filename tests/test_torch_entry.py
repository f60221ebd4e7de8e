"""The port's entry points: config, CLI, device selection, import hygiene."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch import cli as tcli
from strotss_torch.api import resolve_device
from strotss_tpu import cli as jcli
from strotss_tpu.config import StrotssConfig as JaxConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_fields_and_defaults_match_jax():
    t = {f.name: f.default for f in dataclasses.fields(
        strotss_torch.StrotssConfig)}
    j = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert t == j
    cfg = strotss_torch.StrotssConfig()
    assert cfg.scale_sizes() == JaxConfig().scale_sizes() == [64, 128, 256,
                                                              512]
    assert cfg.initial_alpha() == JaxConfig().initial_alpha()


def test_cli_parses_the_jax_flags():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    t_opts = {s for a in tp._actions for s in a.option_strings}
    for a in jp._actions:
        for s in a.option_strings:
            assert s in t_opts, s
    argv = ["c.png", "s.png"]
    jd, td = vars(jp.parse_args(argv)), vars(tp.parse_args(argv))
    for k, v in jd.items():
        assert td[k] == v, k
    args = tp.parse_args(argv + ["--gpu_id", "3", "--level", "2"])
    assert args.device_id == 3 and args.level == 2


def _pngs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name, shape in (("c.png", (40, 48, 3)), ("s.png", (36, 52, 3)),
                        ("a.png", (44, 36, 3))):
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            tmp_path / name)


_TINY_CLI = ["--cpu", "--level", "1", "--max_iter", "2", "--taps",
             "block1_conv1", "--compute_dtype", "float32", "--sample_size",
             "64", "--max_size", "48"]


def _spy(monkeypatch):
    """Record each stylize_single call the CLI and the API make."""
    import strotss_torch.api as api

    calls = []
    real = api.stylize_single

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out[1]))
        return out

    monkeypatch.setattr(api, "stylize_single", spy)
    return calls


@pytest.mark.parametrize("flags", [["--init", "{c}"],
                                   ["--remat"],
                                   ["--checkpoint_dir", "{d}"],
                                   ["--styles", "{a}"]])
def test_cli_unported_flags_raise(flags, tmp_path, monkeypatch):
    """These flags once raised NotImplementedError; each now runs on the
    CPU and reaches the run."""
    _pngs(tmp_path)
    calls = _spy(monkeypatch)
    flags = [f.format(c=tmp_path / "c.png", d=tmp_path / "d",
                      a=tmp_path / "a.png") for f in flags]
    out = tmp_path / "out.jpg"
    assert tcli.main([str(tmp_path / "c.png"), str(tmp_path / "s.png"),
                      "-o", str(out)] + _TINY_CLI + flags) == 0
    assert out.exists()
    (args, kw, info), = calls
    cfg = args[2]
    if flags[0] == "--init":
        assert tuple(kw["init_image"].shape) == (1, 40, 48, 3)
    elif flags[0] == "--remat":
        assert cfg.remat
    elif flags[0] == "--checkpoint_dir":
        assert cfg.checkpoint_dir == flags[1]
        assert os.path.exists(os.path.join(flags[1], "state.npz"))
    else:
        assert len(args[1]) == 2 and kw["style_weights"] == [1.0, 1.0]
    assert np.all(np.isfinite(info["scales"][0]["curve"]))


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        strotss_torch.stylize(img, img)
    with pytest.raises(RuntimeError, match="CUDA card"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tcli.main(["c.png", "s.png"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_api_rejects_unported_paths(monkeypatch):
    """A warm start and a style list once raised NotImplementedError; both
    now run on the CPU and reach the run. A bad image shape still
    raises."""
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(1)
    img = rng.random((1, 40, 40, 3)).astype(np.float32)
    cfg = strotss_torch.StrotssConfig(
        levels=1, max_iter=2, sample_size=32, taps=("block1_conv1",),
        compute_dtype="float32")
    warm, _ = strotss_torch.stylize(img, img, cfg, init_image=img[:, :24],
                                    device="cpu")
    cold, _ = strotss_torch.stylize(img, img, cfg, device="cpu")
    assert tuple(calls[0][1]["init_image"].shape) == (1, 24, 40, 3)
    assert (warm.int() - cold.int()).abs().max() > 0
    _, info = strotss_torch.stylize(img, [img, img[:, :, :32]], cfg,
                                    style_weights=[0.5, 0.5], device="cpu")
    assert len(calls[2][0][1]) == 2
    assert np.all(np.isfinite(info["scales"][0]["curve"]))
    with pytest.raises(ValueError, match=r"\(1, H, W, 3\)"):
        strotss_torch.stylize(img[0], img, device="cpu")
    with pytest.raises(ValueError, match=r"style\[1\] must have shape"):
        strotss_torch.stylize(img, [img, img[0]], device="cpu")


def test_api_sharding_still_unported():
    """``shard_spatial`` is not ported (ROADMAP.md Queue 1 item 16);
    ``shard_samples`` without a mesh is refused with the JAX package's
    error (``strotss_tpu/solve.py:237-250``)."""
    img = np.zeros((1, 8, 8, 3), np.float32)
    cfg = strotss_torch.StrotssConfig(shard_spatial=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        strotss_torch.stylize(img, img, cfg, device="cpu")
    cfg = strotss_torch.StrotssConfig(shard_samples=True)
    with pytest.raises(ValueError) as got:
        strotss_torch.stylize(img, img, cfg, device="cpu")
    assert str(got.value) == (
        "cfg.shard_samples needs a mesh with a 'sample' axis — pass "
        "stylize(..., mesh=make_mesh((N,), ('sample',)))")


def test_cli_runs_on_cpu(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name, shape in (("c.png", (40, 48, 3)), ("s.png", (36, 52, 3))):
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            tmp_path / name)
    out = tmp_path / "out.jpg"
    rc = tcli.main([str(tmp_path / "c.png"), str(tmp_path / "s.png"),
                    "-o", str(out), "--cpu", "--level", "1", "--max_iter",
                    "2", "--taps", "block1_conv1", "--compute_dtype",
                    "float32", "--sample_size", "64", "--max_size", "48"])
    assert rc == 0 and out.exists()
    assert Image.open(out).size == (64, 53)  # the 64 px scale of 40x48


def test_no_jax_in_the_port_at_runtime():
    code = ("import sys, strotss_torch, strotss_torch.cli, "
            "strotss_torch.ops.kernels.remd, strotss_torch.ops.kernels."
            "selfsim, strotss_torch.ops.kernels.sinkhorn, "
            "strotss_torch.parallel.batch, strotss_torch.parallel.launch, "
            "strotss_torch.parallel.transport, strotss_torch.serve, "
            "chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'strotss_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_import_statement_of_jax_in_port_files():
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|strotss_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "strotss_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=dict(env, PYTHONPATH=""), capture_output=True,
                           text=True, timeout=120)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
