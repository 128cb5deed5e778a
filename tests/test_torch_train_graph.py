"""The train step's CUDA graphs (``train.step.StepGraphs``).

On the CPU: which steps may replay a graph (``graph_key``: never under a
process group, with lamb or sgd, or with a tensor off the card; a new batch
layout or loss gate is a new kind of step), when a step warms, captures
and replays (``StepGraphs.plan``: never a graph captured on another state,
other optimizer tensors or another gate), ``get_optimizer``'s capturable
mode, and the step's logs outliving the next step.

On the card (``cuda``, B = 8 at 128x128, both families, uint8 images so
that the normalize kernel runs): three seeded steps that warm, capture and
replay against three eager steps from the same state (losses, parameters,
BN statistics, Adam's moments, the heads' dropout masks), and the kernels'
launch counters over replays. This file imports no JAX.
"""

import copy

import pytest
import torch

from dad3dheads_tpu_torch import ops
from dad3dheads_tpu_torch.constants import INPUT_IMAGE_KEY, TARGET_LANDMARKS_HEATMAP
from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
from dad3dheads_tpu_torch.losses import DEFAULT_LOSS_CONFIG, LossModule
from dad3dheads_tpu_torch.train import TrainState, build_train_step, get_optimizer, init_train_state
from dad3dheads_tpu_torch.train import step as step_module
from dad3dheads_tpu_torch.train.step import StepGraphs, graph_key

IMG, B, STEPS = 64, 2, 3
CARD_IMG, CARD_B = 128, 8
ADAM = {"name": "adam", "lr": 1e-4}


@pytest.fixture(scope="module")
def flame_emb():
    return FlameModel.load(), LandmarkEmbedding.load()


def _batch(flame_emb, seed=0, batch=B, img=IMG, device="cpu"):
    flame, emb = flame_emb
    return synthetic_batch(torch.Generator(device=device).manual_seed(seed), flame, emb, batch, img)


def _state(opt=None, seed=0, device="cpu", **model):
    return init_train_state({"backbone": "mobilenet_w1", **model}, opt or ADAM, torch.Generator().manual_seed(seed),
                            device, 5.0)


def _capturable_on_cpu(state: TrainState) -> TrainState:
    """``state`` with an Adam flagged capturable, as the card's is (the CPU
    cannot run it; the decision only reads the flag)."""
    params = list(state.model.parameters())
    state.optimizer = type(state.optimizer)(torch.optim.Adam(params, lr=1e-4, capturable=True), 5.0)
    return state


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor counts as on the card, so that the other conditions of
    ``graph_key`` are seen alone."""
    monkeypatch.setattr(step_module, "_on_cuda", lambda value: True)


GATES = LossModule().gates(0)


@pytest.mark.parametrize("case", ["group", "lamb", "sgd", "cpu_batch"])
def test_graph_key_keeps_these_steps_eager(flame_emb, monkeypatch, case):
    """A process group, lamb, sgd (no capturable update) and a batch off the
    card each make the step eager, whatever the rest allows."""
    batch = _batch(flame_emb)
    if case == "cpu_batch":
        state = _capturable_on_cpu(_state())
    else:
        monkeypatch.setattr(step_module, "_on_cuda", lambda value: True)
        state = _capturable_on_cpu(_state()) if case == "group" else _state({"name": case, "lr": 1e-4})
    assert graph_key(state, batch, GATES, group=object() if case == "group" else None) is None


def test_graph_key_is_the_batch_layout_and_the_gates(flame_emb, on_card):
    """A capturable optimizer and a batch on the card give a key. Another
    batch size or dtype, or another loss gate, gives another key; the same
    layout with other values the same key. Values other than tensors (a
    loader's file names) are not part of it."""
    state = _capturable_on_cpu(_state())
    batch = _batch(flame_emb)
    key = graph_key(state, batch, GATES)
    assert key is not None
    assert graph_key(state, _batch(flame_emb, seed=1), GATES) == key
    assert graph_key(state, {**batch, "IMAGE_FILENAME_KEY": ["a.png", "b.png"]}, GATES) == key
    assert graph_key(state, _batch(flame_emb, batch=B + 1), GATES) != key
    half = {**batch, INPUT_IMAGE_KEY: batch[INPUT_IMAGE_KEY].half()}
    assert graph_key(state, half, GATES) != key
    gated = LossModule([*DEFAULT_LOSS_CONFIG[:-1], {**DEFAULT_LOSS_CONFIG[-1], "epoch_start": 1}])
    assert graph_key(state, batch, gated.gates(0)) != graph_key(state, batch, gated.gates(1))


def _updated(state: TrainState) -> TrainState:
    """``state`` after one update of zero gradients: the optimizer holds its
    tensors, as after a first step."""
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step(1.0)
    return state


@pytest.mark.parametrize("change", ["fresh_state", "load_state_dict", "epoch_gate", "flame"])
def test_plan_replays_no_graph_captured_before_a_change(flame_emb, change):
    """warm, capture, replay for one key; then a fresh state, optimizer
    tensors replaced by ``load_state_dict``, a new epoch gate or another
    FLAME model start over at warm, and a graph captured before is gone
    (or, for the gate, under another key)."""
    flame = flame_emb[0]
    state = _updated(_state())
    gated = LossModule([*DEFAULT_LOSS_CONFIG[:-1], {**DEFAULT_LOSS_CONFIG[-1], "epoch_start": 1}])
    key = ("layout", gated.gates(state.epoch))
    graphs = StepGraphs()
    assert [graphs.plan(state, flame, key) for _ in range(2)] == ["warm", "capture"]
    graphs.captured[key] = "graph"
    assert graphs.plan(state, flame, key) == "replay"
    if change == "fresh_state":
        state = _updated(_state())
    elif change == "load_state_dict":
        state.optimizer.load_state_dict(copy.deepcopy(_updated(_state(seed=1)).optimizer.state_dict()))
    elif change == "epoch_gate":
        state.epoch = 1
        key = ("layout", gated.gates(state.epoch))
    else:
        flame = copy.deepcopy(flame)
    assert graphs.plan(state, flame, key) == "warm"
    assert key not in graphs.captured


def test_plan_keeps_its_graphs_across_the_first_update_and_a_reload_of_the_same_tensors(flame_emb):
    """A fresh state's first step makes the optimizer's tensors: its second
    step still captures. Loading the optimizer's own state dict keeps those
    tensors, and so the graphs."""
    flame = flame_emb[0]
    state = _state()
    graphs = StepGraphs()
    assert graphs.plan(state, flame, "k") == "warm"
    _updated(state)
    assert graphs.plan(state, flame, "k") == "capture"
    graphs.captured["k"] = "graph"
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    assert graphs.plan(state, flame, "k") == "replay"


def test_graphs_go_with_their_state(flame_emb):
    """When the state a step's graphs were captured on is freed, the graphs
    are dropped with it (their memory pool goes back), and the step starts
    over at warm."""
    flame = flame_emb[0]
    state = _updated(_state())
    graphs = StepGraphs()
    assert [graphs.plan(state, flame, "k") for _ in range(2)] == ["warm", "capture"]
    graphs.captured["k"] = "graph"
    del state
    assert graphs.captured == {}
    assert graphs.plan(_updated(_state()), flame, "k") == "warm"


@pytest.mark.parametrize("name", ["adam", "adamw", "radam", "sgd", "lamb"])
def test_get_optimizer_is_not_capturable_on_the_cpu(name):
    """Parameters on the CPU: no optimizer takes the capturable mode (the CPU
    path is unchanged); a state dict that carries it from the card loads
    into the CPU's optimizer without it, and the update runs."""
    model = torch.nn.Linear(3, 2)
    opt = get_optimizer({"name": name, "lr": 1e-3}, model.parameters(), gradient_clip_val=1.0)
    assert not opt.capturable
    if name in ("adam", "adamw", "radam"):
        saved = opt.state_dict()
        saved["param_groups"] = [{**g, "capturable": True} for g in saved["param_groups"]]
        opt.load_state_dict(saved)
        assert not opt.capturable
    model(torch.ones(4, 3)).sum().backward()
    opt.step(0.5)


def test_logs_keep_their_values_after_the_next_step(flame_emb):
    """The logs a step returns are its own: the next step leaves them be."""
    flame = flame_emb[0]
    state = _state()
    step = build_train_step(img_size=IMG)
    first = step(state, flame, _batch(flame_emb, seed=0))
    kept = {k: v.clone() for k, v in first.items()}
    step(state, flame, _batch(flame_emb, seed=1))
    for k, v in kept.items():
        assert torch.equal(first[k], v), k


def test_launch_counters_add_and_restore():
    before = ops.launch_counts()
    delta = tuple(range(1, len(ops.LAUNCH_COUNTERS) + 1))
    ops.add_launches(delta)
    assert ops.launch_counts() == tuple(b + d for b, d in zip(before, delta))
    ops.add_launches(tuple(-d for d in delta))
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_batches(seed=0):
    """Three batches as the benchmark feeds them: uint8 images and no
    heatmap, so the step runs the normalize kernel and encodes heatmaps."""
    flame, emb = FlameModel.load(device="cuda"), LandmarkEmbedding.load(device="cuda")
    out = []
    for i in range(STEPS):
        b = synthetic_batch(torch.Generator(device="cuda").manual_seed(seed + i), flame, emb, CARD_B, CARD_IMG)
        b.pop(TARGET_LANDMARKS_HEATMAP)
        b[INPUT_IMAGE_KEY] = ((b[INPUT_IMAGE_KEY].clamp(-2, 2) + 2) * 63.75).to(torch.uint8)
        out.append(b)
    return flame, out


def _dropout_probes(model):
    """Records (input nonzero, output nonzero) of each Dropout's every
    forward: the mask wherever the input is nonzero."""
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.register_forward_hook(lambda mod, inp, out: seen.append((inp[0] != 0, out != 0)))
    return seen


def _run(backbone, graphed: bool, seeds=(11, 12, 13)):
    """Three steps from one seeded state, the global RNG seeded before each:
    one step function (warm, capture and replay, replay) or a new one a step
    (each step eager). Returns per step the logs, the dropout records, and
    the launch counters' change; and the final state."""
    flame, batches = _card_batches()
    state = _state(backbone=backbone, device="cuda", dtype="bfloat16")
    seen = _dropout_probes(state.model)
    graphed_step = build_train_step(img_size=CARD_IMG)
    out = []
    for i, (s, batch) in enumerate(zip(seeds, batches)):
        step = graphed_step if graphed else build_train_step(img_size=CARD_IMG)
        torch.manual_seed(s)
        before = ops.launch_counts()
        n = len(seen)
        logs = step(state, flame, batch)
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(ops.launch_counts(), before))
        out.append({"logs": {k: float(v) for k, v in logs.items()}, "launches": launches,
                    "dropout": [(a.clone(), b.clone()) for a, b in (seen[n:] or out[-1]["probes"])],
                    "probes": seen[n:] or out[-1]["probes"]})
    if graphed:
        assert len(graphed_step.graphs.captured) == 1
    return out, state


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet_w1"])
def test_card_replay_matches_eager_steps(backbone):
    """Three seeded steps, warm, capture and replay, against three eager
    steps from the same state, held to the tolerances of
    test_torch_train_step.py: losses 1e-4 relative, grad_norm 1e-2, the
    metric panel 1e-3; each parameter's and each Adam moment's L2 gap under
    10% of the norm (mu; nu 20%; the update's gap under 25% of its norm);
    BN statistics within 1e-3 of each tensor's largest value. The heads'
    dropout masks agree wherever both inputs are nonzero, and drop about
    the configured 30%. Every kernel launch is counted once a step."""
    cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two runs then part only where their kernels differ
    try:
        eager, eager_state = _run(backbone, graphed=False)
        graph, graph_state = _run(backbone, graphed=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for i, (e, g) in enumerate(zip(eager, graph)):
        assert set(e["logs"]) == set(g["logs"])
        for k, v in e["logs"].items():
            rel = 1e-2 if k == "grad_norm" else 1e-3 if k.startswith("metrics/") else 1e-4
            assert g["logs"][k] == pytest.approx(v, rel=rel, abs=1e-6), (i, k, g["logs"][k], v)
        assert g["launches"] == e["launches"], (i, g["launches"], e["launches"])
        assert len(e["dropout"]) == len(g["dropout"]) == 3
        for (ein, eout), (gin, gout) in zip(e["dropout"], g["dropout"]):
            both = ein & gin
            assert torch.equal(eout[both], gout[both]), i
            dropped = 1.0 - float(eout[both].float().mean())
            assert 0.2 < dropped < 0.4, dropped
    assert eager[0]["launches"][2:4] == (1, 1) and eager[0]["launches"][0] == 1
    start = _state(backbone=backbone, device="cuda", dtype="bfloat16")
    p0 = {k: v.detach() for k, v in start.model.named_parameters()}
    pe = {k: v.detach() for k, v in eager_state.model.named_parameters()}
    pg = {k: v.detach() for k, v in graph_state.model.named_parameters()}
    update = sum(float((pe[k] - p0[k]).square().sum()) for k in p0) ** 0.5
    gap = sum(float((pg[k] - pe[k]).square().sum()) for k in p0) ** 0.5
    print(f"{backbone}: update gap {gap / update:.3e} of the update's norm")
    assert update > 1e-4 and gap <= 0.25 * update
    be, bg = dict(eager_state.model.named_buffers()), dict(graph_state.model.named_buffers())
    for k, v in be.items():
        if v.is_floating_point():
            torch.testing.assert_close(bg[k], v, rtol=0, atol=1e-3 * float(v.abs().max()) + 1e-12, msg=k)
        else:
            assert torch.equal(bg[k], v), k
    se = [eager_state.optimizer.optimizer.state[p] for p in eager_state.model.parameters()]
    sg = [graph_state.optimizer.optimizer.state[p] for p in graph_state.model.parameters()]
    for name, tol in (("exp_avg", 0.1), ("exp_avg_sq", 0.2)):
        num = sum(float((g[name] - e[name]).square().sum()) for e, g in zip(se, sg)) ** 0.5
        den = sum(float(e[name].square().sum()) for e in se) ** 0.5
        print(f"{backbone}: {name} gap {num / den:.3e}")
        assert num <= tol * den, (name, num / den)
    assert all(float(g["step"]) == STEPS for g in sg)


@pytest.mark.cuda
def test_card_logs_of_a_replay_outlive_the_next_replay():
    """Logs of replays are copies: two more replays leave them as read."""
    cuda()
    flame, batches = _card_batches()
    state = _state(device="cuda", dtype="bfloat16")
    step = build_train_step(img_size=CARD_IMG)
    logs = [step(state, flame, b) for b in batches]
    read = [{k: float(v) for k, v in x.items()} for x in logs]
    for b in batches:
        step(state, flame, b)
    assert [{k: float(v) for k, v in x.items()} for x in logs] == read
    assert read[1]["loss"] != read[2]["loss"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "adamw", "radam", "sgd", "lamb"])
def test_card_get_optimizer_is_capturable_where_torch_has_the_mode(name):
    cuda()
    model = torch.nn.Linear(3, 2).cuda()
    opt = get_optimizer({"name": name, "lr": 1e-3}, model.parameters())
    assert opt.capturable == (name in ("adam", "adamw", "radam"))
