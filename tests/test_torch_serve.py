"""The port's serving loop (``strotss_torch.serve``) on the CPU: JSONL jobs
in, JSONL results out, batching, warm-up, SIGTERM drains, warm chains.
The cases of ``tests/test_serve.py`` that need no JAX, run on ``--cpu``
at a tiny size (one 64 px scale, 2 steps, one tap, float32)."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from strotss_torch import serve
from strotss_tpu import serve as jserve

TINY = ["--cpu", "--level", "1", "--max_iter", "2", "--compute_dtype",
        "float32", "--no_pallas", "--taps", "block1_conv1"]


@pytest.fixture(autouse=True)
def logger_streams():
    """serve points the shared logger at stderr; each test gets back the
    streams it found, so no later test writes to a closed capture. The
    jobs are tiny: one torch thread keeps them quick beside other test
    processes."""
    lg = logging.getLogger("STROTSS")
    saved = [(h, h.stream) for h in lg.handlers
             if isinstance(h, logging.StreamHandler)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for h, stream in saved:
        h.stream = stream


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)
    return str(path)


def _noise(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _write_inputs(tmp_path, rng):
    return (_png(tmp_path / "c.png", _noise(rng, 40, 48)),
            _png(tmp_path / "s.png", _noise(rng, 44, 36)))


def _serve(tmp_path, jobs, extra=(), name="jobs"):
    jp = str(tmp_path / f"{name}.jsonl")
    rp = str(tmp_path / f"{name}_results.jsonl")
    with open(jp, "w") as f:
        for job in jobs:
            f.write((job if isinstance(job, str) else json.dumps(job)) + "\n")
    assert serve.main(["--jobs", jp, "--results", rp, *TINY, *extra]) == 0
    with open(rp) as f:
        return [json.loads(line) for line in f]


def _read(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(int)


def test_parser_has_the_jax_flags_and_defaults():
    jp, tp = jserve.build_parser(), serve.build_parser()
    t_opts = {s for a in tp._actions for s in a.option_strings}
    for a in jp._actions:
        for s in a.option_strings:
            assert s in t_opts, s
    jd, td = vars(jp.parse_args([])), vars(tp.parse_args([]))
    assert {k: td[k] for k in jd} == jd
    assert td["cpu"] is False


def test_serve_singles_and_bad_jobs(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    o1, o2 = str(tmp_path / "o1.jpg"), str(tmp_path / "o2.jpg")
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": o1},
        "this is not json {",
        {"content": str(tmp_path / "missing.png"), "style": sp,
         "output": str(tmp_path / "o_bad.jpg")},
        {"content": cp, "style": sp},  # missing 'output'
        {"content": cp, "style": sp, "output": o2, "seed": 7},
    ])
    assert [r["ok"] for r in results] == [True, False, False, False, True]
    assert os.path.exists(o1) and os.path.exists(o2)
    assert "FileNotFoundError" in results[2]["error"]
    assert "output" in results[3]["error"]
    assert results[0]["seconds"] > 0 and "loss" in results[0]
    a, b = _read(o1), _read(o2)  # another seed: another image
    assert a.shape == b.shape and np.abs(a - b).max() > 0


def test_serve_batch_groups_same_shape_jobs(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    outs = [str(tmp_path / f"b{i}.jpg") for i in range(4)]
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": outs[0]},
        # alpha rides the pair axis: an alpha override batches
        {"content": cp, "style": sp, "output": outs[1], "alpha": 8.0},
        {"content": cp, "style": sp, "output": outs[2]},
        # start_level opts out: it flushes the pending group (of one, run
        # singly) and runs singly itself
        {"content": cp, "style": sp, "output": outs[3], "start_level": 0},
    ], extra=("--batch", "2"))
    assert [r["ok"] for r in results] == [True, True, True, True]
    assert results[0].get("batched") == 2 and results[1].get("batched") == 2
    assert "batched" not in results[2] and "batched" not in results[3]
    assert all(os.path.exists(o) for o in outs)
    # the per-pair alpha is live inside the batch
    assert np.abs(_read(outs[0]) - _read(outs[1])).max() > 0


def test_serve_full_batch_flushes_before_next_read(tmp_path, rng,
                                                   monkeypatch):
    """A queue feeding stdin gets a batch's results as soon as the batch
    fills, not when the next job arrives."""
    cp, sp = _write_inputs(tmp_path, rng)
    outs = [str(tmp_path / f"f{i}.jpg") for i in range(2)]
    rp = str(tmp_path / "flush_results.jsonl")

    class _Queue:
        def __init__(self):
            self.lines = [json.dumps({"content": cp, "style": sp,
                                      "output": o}) + "\n" for o in outs]

        def readline(self):
            if self.lines:
                return self.lines.pop(0)
            with open(rp) as f:
                done = [json.loads(line) for line in f]
            assert len(done) == 2 and all(r["ok"] for r in done), done
            return ""

    monkeypatch.setattr("sys.stdin", _Queue())
    assert serve.main(["--jobs", "-", "--results", rp, "--batch", "2",
                       *TINY]) == 0
    with open(rp) as f:
        assert [json.loads(line)["batched"] for line in f] == [2, 2]


def test_serve_batch_failure_falls_back_to_singles(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    ok_out = str(tmp_path / "good.jpg")
    bad_out = str(tmp_path / "no_such_dir" / "bad.jpg")  # unwritable
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": ok_out},
        {"content": cp, "style": sp, "output": bad_out},
    ], extra=("--batch", "2"))
    assert [r["ok"] for r in results] == [True, False]
    assert os.path.exists(ok_out)
    assert "batched" not in results[0]  # completed by the single retry
    assert "FileNotFoundError" in results[1]["error"]


def test_serve_warmup_and_batch_loss(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    outs = [str(tmp_path / f"w{i}.jpg") for i in range(2)]
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": outs[0]},
        {"content": cp, "style": sp, "output": outs[1]},
    ], extra=("--batch", "2", "--warmup", "40x48:44x36"))
    assert [r["ok"] for r in results] == [True, True]
    assert all(r.get("batched") == 2 for r in results)
    assert all(np.isfinite(r["loss"]) for r in results)
    assert len(results) == 2  # the warm-up's jobs emit nothing


@pytest.mark.parametrize("spec", ["not-a-size", "4x4:4x4:4x4"])
def test_serve_warmup_rejects_bad_spec(tmp_path, spec):
    with pytest.raises(ValueError, match="HxW"):
        serve.main(["--jobs", str(tmp_path / "none.jsonl"), "--cpu",
                    "--warmup", spec])


def test_image_size_matches_load_image(tmp_path, rng):
    from strotss_torch.utils.io import image_size, load_image

    p = _png(tmp_path / "odd.png", _noise(rng, 37, 51))
    for ms in (None, 24, 96):  # identity, downscale, upscale
        assert image_size(p, max_size=ms) == tuple(
            load_image(p, max_size=ms).shape[1:3])
    with pytest.raises(FileNotFoundError):
        image_size(str(tmp_path / "nope.png"))


def test_serve_stdin_stream(tmp_path, rng, monkeypatch):
    import io as _io

    cp, sp = _write_inputs(tmp_path, rng)
    op = str(tmp_path / "stdin_out.jpg")
    rp = str(tmp_path / "stdin_results.jsonl")
    monkeypatch.setattr("sys.stdin", _io.StringIO(json.dumps(
        {"content": cp, "style": sp, "output": op}) + "\n"))
    assert serve.main(["--jobs", "-", "--results", rp, *TINY]) == 0
    with open(rp) as f:
        results = [json.loads(line) for line in f]
    assert len(results) == 1 and results[0]["ok"] and os.path.exists(op)


def test_serve_stdout_is_pure_jsonl(tmp_path, rng, capsys):
    """Every stdout line parses as JSON; the shared logger's lines (the
    weights loader, write_image, the summary) go to stderr."""
    cp, sp = _write_inputs(tmp_path, rng)
    jp = str(tmp_path / "jobs.jsonl")
    with open(jp, "w") as f:
        f.write(json.dumps({"content": cp, "style": sp,
                            "output": str(tmp_path / "o.jpg")}) + "\n")
        f.write("not json {\n")
    assert serve.main(["--jobs", jp, *TINY]) == 0
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 2, f"expected 2 result lines, got: {lines!r}"
    assert [json.loads(ln)["ok"] for ln in lines] == [True, False]
    assert "Served 1 jobs" in err


def _main_thread():
    import threading

    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")


def test_serve_sigterm_while_reading_drains_pending(tmp_path, rng,
                                                    monkeypatch):
    """SIGTERM while blocked reading the job stream ends the wait, runs
    the pending jobs and exits 0, the old handler back in place."""
    import signal
    import threading

    _main_thread()
    cp, sp = _write_inputs(tmp_path, rng)
    op = str(tmp_path / "drain_out.jpg")
    rp = str(tmp_path / "drain_results.jsonl")

    class SigtermStdin:
        def __init__(self, lines):
            self.lines = list(lines)
            self.blocked = threading.Event()

        def readline(self):
            if self.lines:
                return self.lines.pop(0)
            signal.raise_signal(signal.SIGTERM)
            self.blocked.wait()  # stays blocked, like an idle pipe
            return ""

    fake = SigtermStdin([json.dumps({"content": cp, "style": sp,
                                     "output": op}) + "\n"])
    monkeypatch.setattr("sys.stdin", fake)
    before = signal.getsignal(signal.SIGTERM)
    # --batch 2: the job waits for a batch-mate, so only the drain can
    # have run it
    rc = serve.main(["--jobs", "-", "--results", rp, "--batch", "2", *TINY])
    fake.blocked.set()
    assert rc == 0
    assert signal.getsignal(signal.SIGTERM) is before
    with open(rp) as f:
        results = [json.loads(line) for line in f]
    assert len(results) == 1 and results[0]["ok"] and os.path.exists(op)


def test_serve_sigterm_mid_job_finishes_job_then_exits(tmp_path, rng,
                                                       monkeypatch):
    """SIGTERM during a job does not cut it: the job finishes and emits,
    then the loop stops reading."""
    import signal

    _main_thread()
    cp, sp = _write_inputs(tmp_path, rng)
    o1, o2 = str(tmp_path / "mid1.jpg"), str(tmp_path / "mid2.jpg")
    orig = serve._run_single

    def run_single_then_sigterm(args, job, vgg_params):
        result = orig(args, job, vgg_params)
        signal.raise_signal(signal.SIGTERM)  # sets the flag, never raises
        return result

    monkeypatch.setattr(serve, "_run_single", run_single_then_sigterm)
    results = _serve(tmp_path, [{"content": cp, "style": sp, "output": o1},
                                {"content": cp, "style": sp, "output": o2}])
    assert len(results) == 1 and results[0]["ok"]
    assert os.path.exists(o1) and not os.path.exists(o2)


@pytest.mark.parametrize("extra", [["--batch", "2", "--data_devices", "2"],
                                   ["--data_devices", "1",
                                    "--allow_cpu_devices"]])
def test_serve_data_devices_is_refused(tmp_path, extra):
    """Sharding batches over devices is ROADMAP.md Queue 1 item 13: exit
    code 2, the JAX package's code for a mesh it cannot build."""
    jp = str(tmp_path / "empty.jsonl")
    open(jp, "w").close()
    assert serve.main(["--jobs", jp, "--cpu", *extra]) == 2


def test_serve_without_a_card_needs_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jp = str(tmp_path / "empty.jsonl")
    open(jp, "w").close()
    assert serve.main(["--jobs", jp]) == 2
    assert serve.main(["--jobs", jp, "--cpu"]) == 0


def _slow_stream():
    import threading

    class SlowStream:
        def __init__(self):
            self.ev = threading.Event()
            self.calls = 0

        def readline(self):
            self.calls += 1
            if self.calls == 1:
                self.ev.wait()
                return '{"content": "c"}\n'
            return ""

    return SlowStream()


def test_line_reader_grace_recovers_consumed_line():
    """A line the reader takes from the stream as the drain flag flips is
    recovered by one bounded grace read."""
    s = _slow_stream()
    r = serve._LineReader(s)
    assert r.readline(lambda: True) is None
    assert r.grace_line(timeout=0.05) is None
    s.ev.set()
    assert r.grace_line(timeout=5.0) == '{"content": "c"}\n'


def test_line_reader_grace_without_outstanding_read():
    import io as _io

    r = serve._LineReader(_io.StringIO("a\n"))
    assert r.readline(lambda: False) == "a\n"
    assert r.grace_line(timeout=0.05) is None


def test_job_lines_drain_recovers_consumed_line(monkeypatch):
    import threading

    s = _slow_stream()
    monkeypatch.setattr("sys.stdin", s)
    threading.Timer(0.3, s.ev.set).start()
    assert list(serve._job_lines("-", should_stop=lambda: True)) == [
        '{"content": "c"}']


def test_serve_warm_start_chain(tmp_path, rng):
    """A job with "init" warm-starts from an earlier job's output; warm
    and cold jobs never share a group; cold jobs stay deterministic."""
    cp, sp = _write_inputs(tmp_path, rng)
    o1, o2, o3 = (str(tmp_path / f"w{i}.jpg") for i in range(3))
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": o1},
        {"content": cp, "style": sp, "output": o2, "init": o1},
        {"content": cp, "style": sp, "output": o3},
    ], extra=("--batch", "2"))
    assert [r["ok"] for r in results] == [True, True, True]
    assert all("batched" not in r for r in results)
    a, b, c = _read(o1), _read(o2), _read(o3)
    np.testing.assert_array_equal(a, c)
    assert np.abs(a - b).max() > 0


def test_serve_warm_jobs_batch_together(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    ip1 = _png(tmp_path / "i1.png", _noise(rng, 40, 48))
    ip2 = _png(tmp_path / "i2.png", _noise(rng, 40, 48))
    o1, o2 = str(tmp_path / "s1.jpg"), str(tmp_path / "s2.jpg")
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": o1, "init": ip1},
        {"content": cp, "style": sp, "output": o2, "init": ip2},
    ], extra=("--batch", "2"))
    assert [r.get("batched") for r in results] == [2, 2]
    assert np.abs(_read(o1) - _read(o2)).max() > 0


def test_serve_batched_warm_start_matches_single_when_shapes_differ(
        tmp_path, rng):
    """A batched warm job whose init has another shape than its content
    follows its single warm run (the job's seed): serve stacks each init
    at the first executed scale's size, one resample as the single path
    makes."""
    import strotss_torch
    from strotss_torch.models.weights import load_vgg_params
    from strotss_torch.solve import stylize_single
    from strotss_torch.utils.io import load_image

    cp, sp = _write_inputs(tmp_path, rng)  # content 40x48
    inits = [_png(tmp_path / f"init{i}.png", _noise(rng, 56, 64))
             for i in range(2)]
    batched = [str(tmp_path / f"wb{i}.png") for i in range(2)]
    seeds = [0, 5]
    rb = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": batched[i], "init": inits[i],
         **({"seed": seeds[i]} if seeds[i] else {})} for i in range(2)
    ], extra=("--batch", "2"))
    assert [r.get("batched") for r in rb] == [2, 2]
    params = load_vgg_params("16", False)
    for i in range(2):
        cfg = strotss_torch.StrotssConfig(
            levels=1, max_iter=2, log_every=2, compute_dtype="float32",
            use_pallas=False, taps=("block1_conv1",), precompile=False,
            seed=seeds[i])
        img, _ = stylize_single(load_image(cp), load_image(sp), cfg, params,
                                init_image=load_image(inits[i]))
        a, b = _read(batched[i]), img.numpy().astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_warm_and_cold_jobs_never_share_a_group(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)

    class A:
        max_size = None

    warm = {"content": cp, "style": sp, "output": "o", "init": "p.jpg"}
    cold = {"content": cp, "style": sp, "output": "o"}
    assert serve._batchable(warm) and serve._batchable(cold)
    sw, sc = serve._shape_sig(A(), warm), serve._shape_sig(A(), cold)
    assert sw is not None and sc is not None
    assert sw != sc and sw[:2] == sc[:2]
    assert serve._shape_sig(A(), {"content": "missing.png"}) is None


def test_serve_chain_dependency_never_batches_with_producer(tmp_path, rng):
    """A warm job whose init is a pending job's output does not join its
    producer's group, even with a stale copy of that output on disk."""
    cp, sp = _write_inputs(tmp_path, rng)
    ip0 = _png(tmp_path / "i0.png", _noise(rng, 40, 48))
    o1, o2 = str(tmp_path / "f1.jpg"), str(tmp_path / "f2.jpg")
    _png(o1, _noise(rng, 40, 48))  # stale output of an earlier run
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": o1, "init": ip0},
        {"content": cp, "style": sp, "output": o2, "init": o1},
    ], extra=("--batch", "2"))
    assert [r["ok"] for r in results] == [True, True]
    assert all("batched" not in r for r in results)


def test_serve_multi_style_jobs(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    s2p = _png(tmp_path / "s2.png", _noise(rng, 28, 52))
    outs = [str(tmp_path / f"m{i}.jpg") for i in range(4)]
    results = _serve(tmp_path, [
        {"content": cp, "styles": [sp, s2p], "style_weights": [0.7, 0.3],
         "output": outs[0]},
        {"content": cp, "styles": [sp, s2p], "output": outs[1]},
        {"content": cp, "style": sp, "styles": [sp, s2p],
         "output": outs[2]},
        {"content": cp, "style": sp, "style_weights": [1.0],
         "output": outs[3]},
    ])
    assert [r["ok"] for r in results] == [True, True, False, False]
    assert "exactly one of" in results[2]["error"]
    assert "requires 'styles'" in results[3]["error"]
    assert np.abs(_read(outs[0]) - _read(outs[1])).max() > 0


def test_serve_multi_style_flushes_batch_group(tmp_path, rng):
    cp, sp = _write_inputs(tmp_path, rng)
    s2p = _png(tmp_path / "s2.png", _noise(rng, 28, 52))
    outs = [str(tmp_path / f"f{i}.jpg") for i in range(3)]
    results = _serve(tmp_path, [
        {"content": cp, "style": sp, "output": outs[0]},
        {"content": cp, "styles": [sp, s2p], "output": outs[1]},
        {"content": cp, "style": sp, "output": outs[2]},
    ], extra=("--batch", "2"))
    assert [r["ok"] for r in results] == [True, True, True]
    assert all("batched" not in r for r in results)


def test_serve_job_loss_is_the_same_batched_and_alone(tmp_path, rng):
    """Scheduler invariance: a job's final loss is the same whether it ran
    in a batch (at either position) or alone, float32, rtol 1e-5."""
    cp, sp = _write_inputs(tmp_path, rng)
    job = {"content": cp, "style": sp, "seed": 3, "alpha": 2.0}
    other = {"content": cp, "style": sp, "seed": 11}
    alone = _serve(tmp_path, [dict(job, output=str(tmp_path / "a.png"))],
                   name="alone")
    first = _serve(tmp_path, [dict(job, output=str(tmp_path / "b0.png")),
                              dict(other, output=str(tmp_path / "b1.png"))],
                   extra=("--batch", "2"), name="first")
    second = _serve(tmp_path, [dict(other, output=str(tmp_path / "c0.png")),
                               dict(job, output=str(tmp_path / "c1.png"))],
                    extra=("--batch", "2"), name="second")
    assert first[0]["batched"] == second[1]["batched"] == 2
    np.testing.assert_allclose(first[0]["loss"], alone[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(second[1]["loss"], alone[0]["loss"],
                               rtol=1e-5)
    assert abs(first[1]["loss"] - first[0]["loss"]) > 0
