"""The step as a replayed CUDA graph (``strotss_torch.graphs``).

On the CPU: which calls take the graph (``programs.step_route`` and the
``step_impl`` that ``spec_from_config`` sets), the cache key, the copies'
refills, the structure of a step's inputs, which graphs a finished call
keeps, and that the default route leaves every CPU result bit for bit.
Marked ``cuda``: the graph against the eager step on the card from one
state: the coordinates bit for bit; under PyTorch's deterministic
algorithms the loss rows, the pyramid, the RMSprop slots and the
generators bit for bit after a captured step and after calls of replayed
steps, for one pair, a cache hit with other images and generators, and a
batch of 8 pairs; another alpha captured anew; under the default switches
the loss rows over a scale's calls of 1, 2 and 7 steps (the benchmark's
split) within the gap two eager runs show.

This file imports neither JAX nor the JAX package::

    python -m pytest --noconftest tests/test_torch_graph.py -q
"""

import numpy as np
import pytest
import torch

import strotss_torch
from strotss_torch import graphs, programs, solve
from strotss_torch.models.vgg import VGG
from strotss_torch.models.weights import random_params
from strotss_torch.ops.losses import moment_stats
from strotss_torch.ops.sampling import (
    full_grid_coords,
    sample_style,
    strided_grid_coords,
)
from strotss_torch.parallel import batch, stylize_batch
from strotss_torch.utils import timing


def _cfg(**kw):
    base = dict(levels=2, max_iter=2, sample_size=32,
                compute_dtype="float32", taps=("block1_conv1",))
    return strotss_torch.StrotssConfig(**dict(base, **kw))


def _img(seed, b=1, h=40, w=48):
    return torch.tensor(np.random.default_rng(seed).random((b, h, w, 3)),
                        dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return random_params("16", 0)


# --- the route -----------------------------------------------------------

_INELIGIBLE = {
    "masks": ({}, {"masked": True}),
    "no kernels": ({"use_pallas": False}, {}),
    "sinkhorn": ({"use_sinkhorn": True}, {}),
    "shard_samples": ({"shard_samples": True}, {}),
    "shard_spatial": ({"shard_spatial": True}, {}),
    "remat": ({"remat": True}, {}),
    "checkpoints": ({"checkpoint_dir": "ck"}, {}),
}


@pytest.mark.parametrize("batched", [False, True])
def test_spec_takes_the_graph_route_by_default(batched):
    spec = programs.spec_from_config(strotss_torch.StrotssConfig(), "cuda",
                                     batched=batched)
    assert spec.step_impl == "auto"
    assert programs.step_route(spec, "cuda", [object()]) == "graph"


@pytest.mark.parametrize("case", sorted(_INELIGIBLE))
def test_spec_keeps_ineligible_runs_eager(case):
    kw, where = _INELIGIBLE[case]
    spec = programs.spec_from_config(strotss_torch.StrotssConfig(**kw),
                                     "cuda", **where)
    assert spec.step_impl == "eager"
    assert programs.step_route(spec, "cuda", [object()]) == "eager"


@pytest.mark.parametrize("case", ["cpu", "no generators", "sample group",
                                  "spatial", "eager spec"])
def test_step_route_takes_the_eager_step(case):
    spec = programs.spec_from_config(strotss_torch.StrotssConfig(), "cuda")
    args = {"device": "cuda", "step_gens": [object()], "sample_group": None,
            "spatial": None}
    if case == "cpu":
        args["device"] = "cpu"
    elif case == "no generators":
        args["step_gens"] = None
    elif case == "sample group":
        args["sample_group"] = object()
    elif case == "spatial":
        args["spatial"] = object()
    else:
        spec = spec._replace(step_impl="eager")
    assert programs.step_route(spec, **args) == "eager"


@pytest.mark.parametrize("route", ["graph", "fast"])
def test_step_route_refuses_an_unknown_route(route):
    spec = programs.spec_from_config(strotss_torch.StrotssConfig(), "cpu")
    with pytest.raises(ValueError, match="step_impl must be"):
        programs.step_route(spec._replace(step_impl=route), "cuda", [])


def _spy(monkeypatch, module, name):
    """Record (spec, step_gens) of each step-layer call through
    ``module.name``."""
    seen = []
    orig = getattr(module, name)

    def steps(spec, *a):
        seen.append((spec, a[-1]))
        return orig(spec, *a)
    monkeypatch.setattr(module, name, steps)
    return seen


def _masks(b=None):
    cm = np.zeros((2, 40, 48, 1), np.float32)
    sm = np.zeros((2, 40, 40, 1), np.float32)
    cm[0, :, :24], cm[1, :, 24:] = 1.0, 1.0
    sm[0, :20], sm[1, 20:] = 1.0, 1.0
    if b is None:
        return cm, sm
    return np.stack([cm] * b), np.stack([sm] * b)


@pytest.mark.parametrize("case", ["default", "masks", "coords_source",
                                  "checkpoints"])
def test_single_path_names_its_generators_only_where_eligible(
        case, params, monkeypatch, tmp_path):
    """The single path passes its step generator where its coordinates are
    that generator's draws alone; a call on the card takes the graph only
    there."""
    seen = _spy(monkeypatch, solve, "optimization_steps")
    kw, cfg = {}, _cfg()
    if case == "masks":
        kw["content_masks"], kw["style_masks"] = (torch.tensor(m) for m in
                                                  _masks())
    elif case == "coords_source":
        kw["coords_source"] = lambda i, kind, step, hw, n: full_grid_coords(
            torch.Generator().manual_seed(step + 2), hw, n, "cpu")
    elif case == "checkpoints":
        cfg = _cfg(checkpoint_dir=str(tmp_path / "ck"))
    stylize_single_cpu(cfg, params, **kw)
    assert len(seen) == 2
    for spec, gens in seen:
        route = programs.step_route(spec, "cuda", gens)
        assert route == ("graph" if case == "default" else "eager")
        if case == "default":
            assert len(gens) == 1 and isinstance(gens[0], torch.Generator)


def stylize_single_cpu(cfg, params, **kw):
    return solve.stylize_single(_img(1), _img(2, h=40, w=40), cfg, params,
                                **kw)


@pytest.mark.parametrize("case", ["default", "masks", "coords_source"])
def test_batch_path_names_its_generators_only_where_eligible(
        case, params, monkeypatch):
    seen = _spy(monkeypatch, batch, "batch_steps")
    kw = {}
    if case == "masks":
        kw["content_masks"], kw["style_masks"] = _masks(2)
    elif case == "coords_source":
        kw["coords_source"] = lambda b, i, kind, step, hw, n: \
            full_grid_coords(torch.Generator().manual_seed(step + 2 + b), hw,
                             n, "cpu")
    stylize_batch(_img(1, 2).numpy(), _img(2, 2, 40, 40).numpy(), _cfg(),
                  params, alphas=[1.0, 4.0], pair_seeds=[3, 11],
                  device="cpu", **kw)
    assert len(seen) == 2
    for spec, gens in seen:
        route = programs.step_route(spec, "cuda", gens)
        assert route == ("graph" if case == "default" else "eager")
        if case == "default":
            assert len(gens) == 2


def test_default_route_leaves_cpu_results_bit_for_bit(params, monkeypatch):
    """On the CPU ``step_impl='auto'`` runs the eager step: a single run
    and a batch equal their runs under ``'eager'`` bit for bit."""
    def run():
        img, info = stylize_single_cpu(_cfg(), params)
        imgs, binfo = stylize_batch(
            _img(1, 2).numpy(), _img(2, 2, 40, 40).numpy(), _cfg(), params,
            alphas=[1.0, 4.0], pair_seeds=[3, 11], device="cpu")
        return [img, imgs] + [torch.tensor(s["curve"]) for s in
                              info["scales"] + binfo["scales"]]

    auto = run()
    orig = programs.spec_from_config

    def eager(*a, **k):
        return orig(*a, **k)._replace(step_impl="eager")
    monkeypatch.setattr(solve, "spec_from_config", eager)
    monkeypatch.setattr(batch, "spec_from_config", eager)
    for a, b in zip(auto, run()):
        assert torch.equal(a, b)


# --- the key, the copies and the inputs' structure ----------------------

def _key_parts(params, **change):
    """The arguments of ``graphs.graph_key`` for a small step, with
    ``change`` applied."""
    spec = programs.spec_from_config(_cfg(), "cpu")
    vgg = VGG(params, taps=spec.taps, vgg_type=spec.vgg_type,
              compute_dtype=spec.compute_dtype)
    parts = {
        "spec": spec, "alpha": 8.0, "vgg": vgg,
        "feats": [torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 64)],
        "targets": torch.zeros(1, 32, 67),
        "moments": [(torch.zeros(1, 67), torch.zeros(67, 67))],
        "pyramid": [torch.zeros(1, 8, 8, 3), torch.zeros(1, 4, 4, 3)],
        "lr": 2e-3, "rho": 0.99, "eps": 1e-8, "gens": 1}
    parts.update(change)
    return parts


def _key(parts):
    opt = programs.RMSprop(parts["pyramid"], parts["lr"], parts["rho"],
                           parts["eps"])
    return graphs.graph_key(
        ("single", parts["spec"], parts["alpha"]), parts["vgg"],
        [parts["feats"], parts["targets"], parts["moments"]],
        parts["pyramid"], opt, parts["gens"])


_KEY_CHANGES = {
    "spec": lambda p: {"spec": p["spec"]._replace(sample_size=64)},
    "alpha": lambda p: {"alpha": 4.0},
    "feature shape": lambda p: {"feats": [torch.zeros(1, 8, 9, 3),
                                          p["feats"][1]]},
    "feature dtype": lambda p: {"feats": [p["feats"][0],
                                          p["feats"][1].bfloat16()]},
    "feature strides": lambda p: {"feats": [
        p["feats"][0], torch.zeros(1, 64, 8, 8).permute(0, 2, 3, 1)]},
    "feature count": lambda p: {"feats": p["feats"][:1]},
    "targets": lambda p: {"targets": torch.zeros(1, 64, 67)},
    "moments": lambda p: {"moments": p["moments"] * 2},
    "pyramid": lambda p: {"pyramid": [torch.zeros(1, 8, 10, 3),
                                      p["pyramid"][1]]},
    "lr": lambda p: {"lr": 1e-3},
    "rho": lambda p: {"rho": 0.9},
    "eps": lambda p: {"eps": 1e-7},
    "generators": lambda p: {"gens": 2},
    "vgg taps": lambda p: {"vgg": VGG(
        {n: {k: t for k, t in d.items()} for n, d in p["vgg"].params().items()},
        taps=("block1_conv2",), compute_dtype="float32")},
    "vgg dtype": lambda p: {"vgg": VGG(p["vgg"].params(),
                                       taps=p["vgg"].taps,
                                       compute_dtype="bfloat16")},
    "vgg weights": lambda p: {"vgg": VGG(
        {n: {"kernel": d["kernel"].double(), "bias": d["bias"]}
         for n, d in p["vgg"].params().items()}, taps=p["vgg"].taps,
        compute_dtype="float32")},
}


@pytest.mark.parametrize("name", sorted(_KEY_CHANGES))
def test_graph_key_changes_with_each_input(name, params):
    base = _key_parts(params)
    assert _key(_key_parts(params, **_KEY_CHANGES[name](base))) != _key(base)


def test_graph_key_keeps_other_values_and_tensors(params):
    """Another call's tensors of the same signatures, with other values,
    and another VGG module on equal parameters share the key."""
    base = _key_parts(params)
    other = _key_parts(params, feats=[torch.ones(1, 8, 8, 3),
                                      torch.rand(1, 8, 8, 64)],
                       targets=torch.rand(1, 32, 67),
                       pyramid=[torch.rand(1, 8, 8, 3),
                                torch.rand(1, 4, 4, 3)],
                       vgg=VGG({n: {k: t.clone() for k, t in d.items()}
                                for n, d in params.items()},
                               taps=base["vgg"].taps,
                               compute_dtype="float32"))
    assert _key(other) == _key(base)
    hash(_key(base))


def test_batch_key_holds_each_pairs_alpha(params):
    spec = programs.spec_from_config(_cfg(), "cpu", batched=True)
    vgg = VGG(params, taps=spec.taps, compute_dtype="float32")
    pyramid = [torch.zeros(2, 8, 8, 3)]
    opt = programs.RMSprop(pyramid, 2e-3)

    def key(alphas):
        pairs = [programs.PairTerms(torch.zeros(1, 32, 67),
                                    [(torch.zeros(1, 67),
                                      torch.zeros(67, 67))], a)
                 for a in alphas]
        return graphs.graph_key(("batch", spec), vgg,
                                [[torch.zeros(2, 8, 8, 3)], pairs], pyramid,
                                opt, 2)

    assert key([1.0, 4.0]) == key([1.0, 4.0])
    assert key([1.0, 4.0]) != key([1.0, 2.0])
    assert key([1.0, 4.0]) != key([4.0, 1.0])


def test_inputs_rebuild_with_their_structure():
    pairs = [programs.PairTerms(torch.zeros(1, 4, 5), [(torch.ones(1, 5),
                                                        torch.ones(5, 5))],
                                0.5, None)]
    inputs = [[torch.zeros(1, 2, 2, 3)], pairs]
    flat = []
    token = graphs._flatten(inputs, flat)
    assert len(flat) == 4
    copies = [t + 1 for t in flat]
    out = graphs._build(token, iter(copies))
    assert isinstance(out[1][0], programs.PairTerms)
    assert out[1][0].alpha == 0.5 and out[1][0].weights is None
    assert isinstance(out[1][0].moments[0], tuple)
    assert all(a is b for a, b in zip(
        [out[0][0], out[1][0].targets, *out[1][0].moments[0]], copies))


def test_copies_refill_only_what_changed():
    """A copy is refilled when its source is another tensor or has been
    written since; what ``hand_back`` wrote counts as there."""
    a, b = torch.zeros(3), torch.ones(2)
    c = graphs._Copies([a, b])
    c.fill([a, b])
    assert torch.equal(c.copies[0], a) and torch.equal(c.copies[1], b)
    c.copies[0].fill_(5.0)
    c.fill([a, b])  # the same tensors, unwritten: nothing copied
    assert torch.equal(c.copies[0], torch.full((3,), 5.0))
    a.add_(2.0)  # written since
    c.fill([a, b])
    assert torch.equal(c.copies[0], torch.full((3,), 2.0))
    b2 = torch.full((2,), 7.0)  # another tensor
    c.fill([a, b2])
    assert torch.equal(c.copies[1], b2)
    c.copies[0].fill_(9.0)
    c.hand_back([a, b2])
    assert torch.equal(a, torch.full((3,), 9.0))
    c.copies[0].fill_(1.0)
    c.fill([a, b2])  # a holds what was handed back: nothing copied
    assert torch.equal(c.copies[0], torch.ones(3))


def test_graph_key_changes_with_the_deterministic_switch(params):
    """A step captured under PyTorch's deterministic algorithms runs other
    kernels: it is another key."""
    base = _key(_key_parts(params))
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert _key(_key_parts(params)) != base
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)


class _Held:
    """A stand-in for an entry whose graph was captured."""

    def __init__(self, params, device="cuda:0"):
        self.graph, self.params = object(), params
        self.device = torch.device(device)


def test_end_call_keeps_only_the_graphs_the_call_used():
    """``end_call`` drops the entries no call used since the last one,
    and the parameter copies and pools that no graph left holds; the
    capture streams stay."""
    cache = graphs.StepGraphs()
    kept, gone = graphs._Copies([torch.zeros(2)]), graphs._Copies(
        [torch.zeros(3)])
    cache.params = {"kept": kept, "gone": gone}
    cache.pools = {torch.device("cuda:0"): (0, 1),
                   torch.device("cuda:1"): (0, 2)}
    cache.entries = {"a": _Held(kept), "b": _Held(gone, "cuda:1"),
                     "c": graphs._Entry()}
    streams = {torch.device("cuda:0"): "s0", torch.device("cuda:1"): "s1"}
    cache.streams = dict(streams)
    cache.used = {"a", "c"}
    cache.end_call()
    assert sorted(cache.entries) == ["a", "c"] and not cache.used
    assert cache.params == {"kept": kept}
    assert list(cache.pools) == [torch.device("cuda:0")]
    cache.end_call()  # a call that used none
    assert not cache.entries and not cache.params and not cache.pools
    assert cache.streams == streams


@pytest.mark.parametrize("path", ["single", "batch"])
def test_a_stylization_drops_the_graphs_it_did_not_use(path, params):
    """A finished stylization ends the cache's call: a graph left from
    another shape is dropped (on the CPU the call itself takes none)."""
    graphs.clear()
    graphs._graphs.entries["other shape"] = graphs._Entry()
    if path == "single":
        stylize_single_cpu(_cfg(levels=1), params)
    else:
        stylize_batch(_img(1, 2).numpy(), _img(2, 2, 40, 40).numpy(),
                      _cfg(levels=1), params, device="cpu")
    assert not graphs._graphs.entries


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _graph_counts():
    now = timing.counters()
    return {k: now.get("graph." + k, 0)
            for k in ("capture", "replay", "hit", "miss")}


class _Scale:
    """One scale of the default run (VGG16, 9 taps, 1024 samples, the bf16
    policy, the kernels) at ``hw``, for ``pairs`` pairs (1: the single
    path): the content features, style targets and moments, the pyramid,
    RMSprop and one step generator a pair, from ``seed``. ``det``: its
    steps run under PyTorch's deterministic algorithms."""

    def __init__(self, device, seed, hw=(96, 128), pairs=1, alpha=1.0,
                 det=False):
        cfg = strotss_torch.StrotssConfig()
        self.spec = programs.spec_from_config(cfg, device,
                                              batched=pairs > 1)
        self.device, self.hw, self.n = device, hw, cfg.sample_size
        self.det = det
        self.vgg = VGG({k: {n: t.to(device) for n, t in p.items()}
                        for k, p in random_params("16", 0).items()},
                       taps=self.spec.taps, vgg_type=self.spec.vgg_type,
                       preprocess_mode=self.spec.preprocess_mode,
                       compute_dtype=self.spec.compute_dtype,
                       block1_impl=self.spec.block1_impl)
        rng = np.random.default_rng(seed)
        content = torch.tensor(rng.random((pairs, *hw, 3)),
                               dtype=torch.float32, device=device)
        style = torch.tensor(rng.random((pairs, hw[0] + 16, hw[1] - 8, 3)),
                             dtype=torch.float32, device=device)
        with programs.precision(self.spec), torch.no_grad():
            _, _, pyr = programs.scale_seed("first", hw, style.shape[1:3],
                                            cfg.pyramid_levels, content,
                                            style, None)
            self.content = programs.extract_hypercolumn(self.vgg, content)
            feats = programs.extract_hypercolumn(self.vgg, style)
            g = torch.Generator(device=device).manual_seed(seed)
            self.targets, self.moments = [], []
            for b in range(pairs):
                xy = full_grid_coords(g, tuple(style.shape[1:3]), self.n,
                                      device)
                t = sample_style(xy, [f[b:b + 1] for f in feats],
                                 self.spec.sample_impl)[None]
                self.targets.append(t)
                self.moments.append([moment_stats(t[0])])
        self.pyramid = [p.detach().contiguous() for p in pyr]
        self.opt = programs.RMSprop(self.pyramid, cfg.lr)
        self.gens = [torch.Generator(device=device).manual_seed(seed + b + 1)
                     for b in range(pairs)]
        self.alpha = alpha
        self.drawn = []

    def clone(self):
        """The same state on tensors and generators of its own."""
        other = object.__new__(_Scale)
        other.__dict__.update(self.__dict__)
        other.pyramid = [p.detach().clone() for p in self.pyramid]
        other.opt = programs.RMSprop(other.pyramid, self.opt.lr)
        other.opt.nu = [v.clone() for v in self.opt.nu]
        other.gens = []
        for g in self.gens:
            h = torch.Generator(device=self.device)
            h.set_state(g.get_state())
            other.gens.append(h)
        other.drawn = []
        return other

    def coords(self, b):
        """Pair b's draw; every tensor drawn is kept, so the buffer a
        graph draws into can be read after its replays."""
        c = strided_grid_coords(self.gens[b], self.hw, self.n,
                                self.device)[None]
        self.drawn.append(c)
        return c

    def steps(self, n, route):
        spec = self.spec._replace(step_impl=route)
        with programs.precision(spec, deterministic=self.det):
            if len(self.gens) == 1:
                return programs.optimization_steps(
                    spec, n, self.vgg, self.content, self.targets[0],
                    self.moments[0], self.alpha, self.pyramid, self.opt,
                    lambda t: self.coords(0), step_gens=self.gens)
            pairs = [programs.PairTerms(t, m, self.alpha)
                     for t, m in zip(self.targets, self.moments)]
            return programs.batch_steps(
                spec, n, self.vgg, self.content, pairs, self.pyramid,
                self.opt, lambda b, t: self.coords(b), step_gens=self.gens)


def _same_state(dst, src):
    """``dst``'s pyramid, slots and generators set to ``src``'s."""
    with torch.no_grad():
        for a, b in zip(dst.pyramid + dst.opt.nu, src.pyramid + src.opt.nu):
            a.copy_(b)
    for a, b in zip(dst.gens, src.gens):
        a.set_state(b.get_state())


def _rel(got, want) -> float:
    return float(((got - want) / want).abs().max())


def _same_run(graph, eager, calls=(1, 1, 2, 7)):
    """Both sides from one state through step-layer calls of ``calls``
    steps, the graph's on the default route and the other's eager, and
    neither ever set to the other's state: after each call the loss rows,
    the pyramid, the RMSprop slots and the generators' states are equal
    bit for bit. Under the deterministic algorithms (``det``) the eager
    step computes the same bits on every run, so this holds the captured
    update and the copies handed back to the eager step exactly. With the
    default calls, the first runs the key's eager step, the second its
    capture and first replay, the last two replays that hand the state
    back after 2 and 7 steps."""
    for n in calls:
        got, want = graph.steps(n, "auto"), eager.steps(n, "eager")
        assert torch.equal(got, want), n
        for a, b in zip(graph.pyramid + graph.opt.nu,
                        eager.pyramid + eager.opt.nu):
            assert torch.equal(a, b), n
        for a, b in zip(graph.gens, eager.gens):
            assert torch.equal(a.get_state(), b.get_state()), n


#: the largest relative gap allowed between a graph's and an eager side's
#: loss rows, free-running from one state over the benchmark's 1 + 2 + 7
#: split under the default switches: twice the widest gap between two
#: eager sides on an H100 over 4 seeds, 2.71e-2 (PERF.md). Each step's
#: backward adds with atomics in an order that changes from run to run,
#: and RMSprop's first updates grow the difference.
_DRIFT_RTOL = 5.5e-2


@pytest.mark.cuda
def test_graph_draws_eager_coordinates_bit_for_bit(cuda_device):
    """Step by step from one state: each step's coordinates, read from the
    buffer the graph draws into after its replay, are the eager draws bit
    for bit; the first step runs eagerly, the second is captured."""
    graphs.clear()
    graph = _Scale(cuda_device, 1)
    eager = graph.clone()
    before = _graph_counts()
    for step in range(5):
        graph.steps(1, "auto")
        eager.steps(1, "eager")
        assert torch.equal(graph.drawn[-1], eager.drawn[-1]), step
        assert torch.equal(graph.gens[0].get_state(),
                           eager.gens[0].get_state())
    after = _graph_counts()
    assert after["capture"] - before["capture"] == 1
    assert after["replay"] - before["replay"] == 4
    # one eager step, one capture: the buffer is the capture's draw
    assert len(graph.drawn) == 2


@pytest.mark.cuda
def test_graph_step_holds_to_eager_from_one_state(cuda_device):
    """Ten steps in calls of one, the eager side set to the graph's state
    before each: the loss rows to rtol 1e-3."""
    graphs.clear()
    graph = _Scale(cuda_device, 8)
    eager = graph.clone()
    for step in range(10):
        _same_state(eager, graph)
        assert _rel(graph.steps(1, "auto"), eager.steps(1, "eager")) \
            <= 1e-3, step


@pytest.mark.cuda
def test_graph_state_equals_eager_bit_for_bit(cuda_device):
    """Under the deterministic algorithms, from one state: one captured
    step, then calls of 2 and 7 replayed steps, leave the loss rows, the
    pyramid, the RMSprop slots and the generator as the eager steps do,
    bit for bit."""
    graphs.clear()
    graph = _Scale(cuda_device, 2, det=True)
    before = _graph_counts()
    _same_run(graph, graph.clone())
    after = _graph_counts()
    assert after["capture"] - before["capture"] == 1
    assert after["replay"] - before["replay"] == 1 + 2 + 7


@pytest.mark.cuda
def test_graph_steps_hold_to_eager_over_the_benchmark_split(cuda_device):
    """Under the default switches, from one state and never reset: calls
    of 1, 2 and 7 steps. The first row (one state, the key's eager step on
    both sides) is equal bit for bit, every row is within
    ``_DRIFT_RTOL``, and the generators' states are equal after each
    call."""
    graphs.clear()
    graph = _Scale(cuda_device, 2)
    eager = graph.clone()
    rows = []
    for n in (1, 2, 7):
        got, want = graph.steps(n, "auto"), eager.steps(n, "eager")
        rows.append((got, want))
        for a, b in zip(graph.gens, eager.gens):
            assert torch.equal(a.get_state(), b.get_state()), n
    got, want = (torch.cat(r) for r in zip(*rows))
    assert got.shape == want.shape == (10, 3)
    assert torch.equal(got[0], want[0])
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= _DRIFT_RTOL


@pytest.mark.cuda
def test_graph_cache_hit_with_other_inputs_and_another_alpha(cuda_device):
    """A captured key replayed for other images, targets and generators is
    a hit that leaves what the eager steps leave, bit for bit under the
    deterministic algorithms; another alpha is another key, captured
    anew."""
    graphs.clear()
    first = _Scale(cuda_device, 3, det=True)
    _same_run(first, first.clone(), calls=(1, 2))
    before = _graph_counts()
    other = _Scale(cuda_device, 4, det=True)
    _same_run(other, other.clone(), calls=(1, 2, 7))
    after = _graph_counts()
    assert after["capture"] == before["capture"]
    assert after["hit"] - before["hit"] == 3
    assert after["miss"] == before["miss"]
    third = _Scale(cuda_device, 5, alpha=0.25, det=True)
    _same_run(third, third.clone())
    assert _graph_counts()["capture"] == after["capture"] + 1


@pytest.mark.cuda
def test_graph_batch_of_eight_pairs(cuda_device):
    """``batch_steps`` for 8 pairs, as ``test_graph_state_equals_eager_bit_
    for_bit``: rows, state and the 8 generators bit for bit."""
    graphs.clear()
    graph = _Scale(cuda_device, 6, hw=(48, 64), pairs=8, det=True)
    eager = graph.clone()
    before = _graph_counts()
    _same_run(graph, eager)
    assert _graph_counts()["capture"] - before["capture"] == 1
    assert [torch.equal(a, b) for a, b in zip(graph.drawn[:8],
                                             eager.drawn[:8])] == [True] * 8


@pytest.mark.cuda
def test_graph_run_equals_its_eager_run(cuda_device):
    """Whole stylizations of two scales x 4 steps through ``stylize``: the
    first call runs each scale's first step eagerly and captures its
    second, the second call replays every step; both hold the first loss
    row, from the run's seeded state, to the eager run's at rtol 1e-3
    (later scales start from states the card's atomic sums have moved)."""
    graphs.clear()
    rng = np.random.default_rng(7)
    content = rng.random((1, 48, 64, 3)).astype(np.float32)
    style = rng.random((1, 64, 56, 3)).astype(np.float32)
    cfg = strotss_torch.StrotssConfig(levels=2, max_iter=4)
    params = random_params("16", 0)
    runs, before = [], _graph_counts()
    for route in ("auto", "auto", "eager"):
        orig = programs.spec_from_config

        def spec(*a, route=route, **k):
            return orig(*a, **k)._replace(step_impl=route)
        solve.spec_from_config = spec
        try:
            runs.append(strotss_torch.stylize(content, style, cfg,
                                              vgg_params=params,
                                              device="cuda")[1])
        finally:
            solve.spec_from_config = orig
    assert _graph_counts()["replay"] - before["replay"] == 2 * 3 + 2 * 4
    for info in runs[:2]:
        np.testing.assert_allclose(info["scales"][0]["curve"][0],
                                   runs[2]["scales"][0]["curve"][0],
                                   rtol=1e-3)
        assert [s["curve"].shape for s in info["scales"]] == [(4, 3)] * 2
        assert all(np.all(np.isfinite(s["curve"])) for s in info["scales"])


@pytest.mark.cuda
def test_graph_run_where_the_grid_has_fewer_points_than_samples(cuda_device):
    """4096 samples on a 48x64 grid: each draw tops up with draws with
    replacement (``torch.multinomial``). Two calls on the default route
    and one eager from the same seed: the first loss rows agree to rtol
    1e-3 and every loss is finite."""
    graphs.clear()
    rng = np.random.default_rng(9)
    content = rng.random((1, 48, 64, 3)).astype(np.float32)
    style = rng.random((1, 64, 56, 3)).astype(np.float32)
    cfg = strotss_torch.StrotssConfig(levels=1, max_iter=3, sample_size=4096)
    params = random_params("16", 0)
    curves = []
    for route in ("auto", "auto", "eager"):
        orig = programs.spec_from_config

        def spec(*a, route=route, **k):
            return orig(*a, **k)._replace(step_impl=route)
        solve.spec_from_config = spec
        try:
            curves.append(strotss_torch.stylize(
                content, style, cfg, vgg_params=params,
                device="cuda")[1]["scales"][0]["curve"])
        finally:
            solve.spec_from_config = orig
    for c in curves:
        assert np.all(np.isfinite(c))
        np.testing.assert_allclose(c[0], curves[2][0], rtol=1e-3)
