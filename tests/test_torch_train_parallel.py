"""The port's training under a (dp, tp) mesh of ranks
(fish_speech_tpu_torch/train, parallel/, cli/finetune.py) on the CPU,
against the JAX package's unsharded step and its step on
`make_mesh(4, tp=2)` (conftest's 8 CPU devices), at the tiny config of
tests/test_train.py.

One module-scoped world a (dp, tp) in {(1, 1), (1, 2), (2, 1), (2, 2)}
on one host, and (2, 2) as two hosts of two ranks and (2, 1) as two
hosts of one, over gloo (`parallel.dryrun.train_dryrun`, spawned ranks
that import nothing of JAX), runs two meshed steps from the JAX tree,
carried across through io/convert.py, each host fed its block of every
global batch; the (1, 2) and (2, 2) worlds snapshot after the
first step and resume from it on the same world, the (2, 1) world
resumes from the (1, 2) snapshot and the (2, 2) world from a one-device
one; the (1, 2) world also holds the tp autograd functions one by one,
and the (1, 2), (2, 1) and two-host (2, 1) worlds run the finetune CLI.
The two-host (2, 2) world also builds meshes at tp = 4 (tp groups across
the hosts: a warning, the batch gathered) and tp = 2; the two-host
(2, 1) world resumes from a snapshot its second host cannot see.

Tolerances: loss and grad norm within 1e-5 relative; parameters within
atol 5e-5 / rtol 5e-4 (tests/test_train.py's own for its sharded step);
the (1, 1) world and a resume on the mesh that wrote the snapshot bit
for bit; the autograd functions' outputs and gradients within 1e-6 of an
unsharded autograd evaluation.
"""

import pytest

pytest.importorskip("safetensors")
pytest.importorskip("tokenizers")

import dataclasses
import json

import jax
import numpy as np
import torch
from safetensors.numpy import load_file, save_file

from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.parallel.mesh import make_mesh
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch.cli import finetune as tft
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.parallel import dryrun
from fish_speech_tpu_torch.parallel.mesh import (
    is_split, lm_param_shapes, lm_param_specs, shard_leaf, unshard_leaf)
from fish_speech_tpu_torch.train import TrainConfig, init_train_state, make_train_step
from fish_speech_tpu_torch.train.checkpoint import save_train_state
from fish_speech_tpu_torch.train.loss import dual_ar_loss
from fish_speech_tpu_torch.train.step import shard_batch, tree_leaves
from test_torch_checkpoint import JCFG, make_lm_state_dict
from test_torch_cli import _write_tokenizer
from test_torch_train import batch_pair, configs

torch.set_num_threads(1)

LR = 1e-3
LOSS_RTOL = 1e-5
P_ATOL, P_RTOL = 5e-5, 5e-4
AUTOGRAD_TOL = 1e-6
WORLD_TIMEOUT_S = 240.0
# (dp, tp[, hosts]): the last two worlds are two hosts of two ranks and of one
MESHED = [(1, 2), (2, 1), (2, 2), (2, 2, 2), (2, 1, 2)]
JC, JT, TC, TT = configs("fish_1_5")
TCFG = TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10, remat=True)
JTCFG = jstep.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10, remat=False)


def _wid(w):
    return f"dp{w[0]}_tp{w[1]}" + (f"_hosts{w[2]}" if len(w) > 2 else "")


def _names(tree) -> dict:
    return {"/".join(p): t.numpy() for p, t in tree_leaves(tree)}


def _jax_names(tree) -> dict:
    return _names(dual_ar_params_from_numpy(jax.tree.map(np.asarray, tree)))


def _unequal_batch(seed, short=10):
    """A batch whose first dp half (rows 0 and 1) is cut to `short`
    positions, so the halves hold very unequal counts of real positions."""
    jb, tb = batch_pair(JT, JC, seed=seed, b=4, s=24)
    tokens, lens = tb["tokens"].numpy().copy(), tb["seq_lens"].numpy().copy()
    lens[:2] = short
    tokens[:2, :, short:] = 0
    tokens[:2, 0, short:] = JT.pad_id
    return ({"tokens": jax.numpy.asarray(tokens), "seq_lens": jax.numpy.asarray(lens)},
            {"tokens": torch.from_numpy(tokens), "seq_lens": torch.from_numpy(lens)})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tree, two batches, the JAX and port references and a
    one-device snapshot after the first step."""
    d = tmp_path_factory.mktemp("train_parallel")
    jp = init_dual_ar_params(jax.random.PRNGKey(11), JC, dtype=jax.numpy.float32)
    tree = jax.tree.map(np.asarray, jp)
    pairs = [_unequal_batch(5), _unequal_batch(40)]
    batches = [{k: v.numpy() for k, v in tb.items()} for _, tb in pairs]

    # JAX, unsharded and on make_mesh(4, tp=2)
    jax_runs = {}
    step = jstep.make_train_step(JC, JT, JTCFG, donate=False)
    p, s = jstep.init_train_state(jp, JTCFG)
    metrics = []
    for jb, _ in pairs:
        p, s, m = step(p, s, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    jax_runs["unsharded"] = (metrics, _jax_names(p))
    mesh = make_mesh(4, tp=2)
    with mesh:
        p, s = jstep.init_train_state(jp, JTCFG, mesh=mesh, cfg=JC)
        step = jstep.make_train_step(JC, JT, JTCFG, donate=False)
        metrics = []
        for jb, _ in pairs:
            p, s, m = step(p, s, jstep.shard_batch(jb, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    jax_runs["mesh"] = (metrics, _jax_names(p))

    # the port on one device, and its snapshot after the first step
    params, state = init_train_state(dual_ar_params_from_numpy(tree), TCFG)
    step = make_train_step(TC, TT, TCFG)
    metrics = []
    for i, (_, tb) in enumerate(pairs):
        params, state, m = step(params, state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            save_train_state(d / "one_device.npz", step=1, params=params, opt_state=state)
    port = (metrics, _names(params))
    return dict(dir=d, tree=tree, batches=batches, pairs=pairs, jax=jax_runs, port=port)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A checkpoint directory and three pairs (tests/test_torch_finetune.py's),
    and the one-device CLI's model.safetensors."""
    d = tmp_path_factory.mktemp("train_parallel_cli")
    ckpt, data = d / "ckpt", d / "data"
    ckpt.mkdir()
    data.mkdir()
    save_file(make_lm_state_dict(JCFG, np.random.default_rng(0)), str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps(dataclasses.asdict(JCFG)))
    _write_tokenizer(ckpt / "tokenizer.json", JCFG)
    rng = np.random.default_rng(3)
    for i, text in enumerate(["hello world .", "speak the text .", "hello the provided text ."]):
        np.save(data / f"s{i}.npy", rng.integers(0, JCFG.codebook_size,
                                                 size=(JCFG.num_codebooks, 6), dtype=np.uint32))
        (data / f"s{i}.txt").write_text(text)

    def argv(out, *extra):
        return ["--checkpoint", str(ckpt), "--data", str(data), "--out", str(d / out),
                "--batch-size", "2", "--seq-len", "48", "--lr", str(LR), "--warmup", "1",
                "--seed", "11", "--steps", "3", "--device", "cpu", *map(str, extra)]

    tft.main(argv("one_device"))
    return dict(dir=d, argv=argv)


def _spec(setup, runs, **extra):
    return dict(cfg=TC, token_cfg=TT, tcfg=TCFG, dtype=torch.float32, params=setup["tree"],
                runs=runs, **extra)


def _collective_inputs():
    rng = np.random.default_rng(9)
    return {"x": rng.normal(size=(5, 8)).astype(np.float32),
            "w": rng.normal(size=(8, 9)).astype(np.float32),
            "gy": rng.normal(size=(5, 9)).astype(np.float32), "width": 7}


@pytest.fixture(scope="module")
def worlds(setup, cli_setup):
    """Rank 0's train_dryrun result of each world (see the module docstring)."""
    d, batches = setup["dir"], setup["batches"]
    straight = {"batches": batches}
    snap12 = str(d / "mesh_1x2.npz")
    specs = {
        (1, 1): _spec(setup, [straight]),
        (1, 2): _spec(setup, [dict(straight, save={"path": snap12, "after": 1},
                                   resume_check=True)],
                      collectives=_collective_inputs(),
                      finetune=[cli_setup["argv"]("tp2", "--tp", 2)]),
        (2, 1): _spec(setup, [straight, {"batches": batches[1:], "resume": snap12}],
                      finetune=[cli_setup["argv"]("dp2"),
                                cli_setup["argv"]("dp_fallback", "--batch-size", 3,
                                                  "--steps", 1)]),
        (2, 2): _spec(setup, [dict(straight, save={"path": str(d / "mesh_2x2.npz"), "after": 1},
                                   resume_check=True),
                              {"batches": batches[1:], "resume": str(d / "one_device.npz")}]),
        (2, 2, 2): _spec(setup, [straight], mesh_probes=[4, 2]),
        # host 1 sees no snapshot where host 0 has one
        (2, 1, 2): _spec(setup, [straight, {"batches": [], "expect_error": True, "resume": [
            str(d / "one_device.npz"), str(d / "host1" / "one_device.npz")]}],
            finetune=[cli_setup["argv"]("dp2_hosts")]),
    }
    return {w: dryrun.train_dryrun(*w[:2], spec, device="cpu", timeout_s=WORLD_TIMEOUT_S,
                                   hosts=w[2] if len(w) > 2 else 1)
            for w, spec in specs.items()}


def _assert_params(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=P_ATOL, rtol=P_RTOL, err_msg=k)


def _assert_metrics(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for k in ("loss", "grad_norm", "slow_loss", "fast_loss"):
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("world", MESHED, ids=_wid)
@pytest.mark.parametrize("ref", ["unsharded", "mesh"])
def test_steps_match_jax(worlds, setup, world, ref):
    """Two meshed steps against JAX's unsharded step and its step on
    make_mesh(4, tp=2): loss and grad norm at each step, the parameters
    after both."""
    run = worlds[world]["runs"][0]
    metrics, params = setup["jax"][ref]
    _assert_metrics(run["steps"], metrics)
    _assert_params(run["params"], params)


@pytest.mark.parametrize("world", MESHED, ids=_wid)
def test_metrics_are_global(worlds, setup, world):
    """The token counts are the whole batch's, exactly, and the
    accuracies the global ones, on every rank."""
    ref = setup["jax"]["unsharded"][0]
    for rank in worlds[world]["ranks"]:
        for g, r in zip(rank["runs"][0]["steps"], ref):
            assert (g["slow_tokens"], g["fast_tokens"]) == (r["slow_tokens"], r["fast_tokens"])
            for k in ("slow_acc", "fast_acc", "loss", "grad_norm"):
                np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL, err_msg=k)


def test_world_of_one_is_bit_equal(worlds, setup):
    """A (1, 1) world runs the unsharded step: metrics and parameters bit
    for bit those of the port's step without a mesh."""
    run = worlds[(1, 1)]["runs"][0]
    metrics, params = setup["port"]
    for g, r in zip(run["steps"], metrics):
        assert {k: g[k] for k in r} == r
    assert run["params"].keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(run["params"][k], params[k], err_msg=k)


@pytest.mark.parametrize("world", [(1, 1)] + MESHED, ids=_wid)
def test_ranks_hold_no_jax(worlds, world):
    """No rank of a train world holds a module of JAX or of the JAX
    package, and each sent the collectives its mesh needs (none alone)."""
    ranks = worlds[world]["ranks"]
    assert len(ranks) == world[0] * world[1]
    for r in ranks:
        assert r["foreign_modules"] == []
        calls = r["runs"][0]["steps"][0]["calls"]
        assert (calls == 0) == (world == (1, 1)), calls


def _collective_refs():
    """The unsharded autograd evaluation of the three products."""
    inp = _collective_inputs()
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    gy = torch.from_numpy(inp["gy"])
    y = x @ w
    (y * gy).sum().backward()
    xh = torch.from_numpy(inp["x"]).requires_grad_(True)
    wh = torch.from_numpy(inp["w"]).requires_grad_(True)
    h = (xh @ wh)[:, :inp["width"]]
    (h * gy[:, :inp["width"]]).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(),
            "h": h.detach().numpy(), "dxh": xh.grad.numpy(), "dwh": wh.grad.numpy()}


def _blocks(a, axis, size=2):
    return [shard_leaf(torch.from_numpy(a), (None,) * axis + ("tp",), None, r, size).numpy()
            for r in range(size)]


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=AUTOGRAD_TOL, rtol=AUTOGRAD_TOL)


def test_copy_autograd(worlds):
    """Copy: the identity forward; its backward sums the partial input
    gradients of each rank's column block, so every rank holds the whole
    x gradient."""
    ref = _collective_refs()
    ranks = [r["collectives"]["copy"] for r in worlds[(1, 2)]["ranks"]]
    for r, got in enumerate(ranks):
        _close(got["out"], _blocks(ref["y"], 1)[r])
        _close(got["grads"][0], ref["dx"])
        _close(got["grads"][1], _blocks(ref["dw"], 1)[r])


def test_reduce_autograd(worlds):
    """Reduce: the all-reduce of the row-split partials forward; the
    gradient passed on as it is, so each rank's gradients are its own
    blocks of the unsharded ones."""
    ref = _collective_refs()
    ranks = [r["collectives"]["reduce"] for r in worlds[(1, 2)]["ranks"]]
    for r, got in enumerate(ranks):
        _close(got["out"], ref["y"])
        _close(got["grads"][0], _blocks(ref["dx"], 1)[r])
        _close(got["grads"][1], _blocks(ref["dw"], 0)[r])


def test_gather_columns_autograd(worlds):
    """GatherColumns (tp.columns over 7 of 9 columns, the last block
    padded): every rank's columns forward, exact; the backward keeps this
    rank's columns, and the input's gradient is summed over the ranks."""
    ref = _collective_refs()
    ranks = [r["collectives"]["columns"] for r in worlds[(1, 2)]["ranks"]]
    dwh = _blocks(ref["dwh"], 1)
    for r, got in enumerate(ranks):
        _close(got["out"], ref["h"])
        _close(got["grads"][0], ref["dxh"])
        _close(got["grads"][1], dwh[r])
    # the padded column and those past the head's width get no gradient
    assert not ranks[1]["grads"][1][:, 2:].any()


@pytest.mark.parametrize("world", [(2, 1), (2, 2)], ids=lambda w: f"dp{w[0]}_tp{w[1]}")
def test_dp_loss_with_unequal_rows(worlds, setup, world):
    """Each dp rank's rows hold another count of real positions; the loss
    divides by the whole batch's count, so it is JAX's global mean, which
    the mean of the two halves' own means is not."""
    _, tb = setup["pairs"][0]
    lens = tb["seq_lens"].numpy()
    assert lens[:2].sum() != lens[2:].sum()
    params = dual_ar_params_from_numpy(setup["tree"])
    with torch.no_grad():
        halves = [float(dual_ar_loss(params, TC, TT, {k: v[lo:lo + 2] for k, v in tb.items()})[0])
                  for lo in (0, 2)]
    jax_loss = setup["jax"]["unsharded"][0][0]["loss"]
    assert abs(np.mean(halves) - jax_loss) > 10 * LOSS_RTOL * jax_loss
    np.testing.assert_allclose(worlds[world]["runs"][0]["steps"][0]["loss"], jax_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", [(1, 2), (2, 2)], ids=lambda w: f"dp{w[0]}_tp{w[1]}")
def test_resume_on_the_same_mesh_is_bit_exact(worlds, world):
    """A snapshot after step 1 reloaded on the mesh that wrote it: each
    rank's parameters, moments and count after step 2 bit for bit the
    straight run's."""
    ranks = worlds[world]["ranks"]
    assert [r["runs"][0]["resume_differs"] for r in ranks] == [[]] * len(ranks)


def test_resume_one_device_to_2x2(worlds, setup):
    """A one-device snapshot (the format of unsharded runs) resumed at
    dp = tp = 2: step 2 against the unsharded continuation."""
    run = worlds[(2, 2)]["runs"][1]
    metrics, params = setup["port"]
    _assert_metrics(run["steps"], metrics[1:])
    _assert_params(run["params"], params)
    _assert_params(run["params"], setup["jax"]["unsharded"][1])


def test_resume_1x2_to_2x1(worlds, setup):
    """A snapshot written at tp = 2 resumed at dp = 2: step 2 against the
    unsharded continuation."""
    run = worlds[(2, 1)]["runs"][1]
    metrics, params = setup["port"]
    _assert_metrics(run["steps"], metrics[1:])
    _assert_params(run["params"], params)


def test_mesh_snapshot_holds_whole_tensors(worlds, setup):
    """The tp = 2 world's snapshot holds the whole tensors: the same
    names, shapes and dtypes as the one-device snapshot's."""
    metas = []
    for name in ("mesh_1x2.npz", "one_device.npz"):
        with np.load(setup["dir"] / name) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            metas.append((meta["params"], meta["opt_state"], meta["step"],
                          {k: z[k].shape for k in z.files if k != "__meta__"}))
    assert metas[0] == metas[1]


@pytest.mark.parametrize("world,out", [((1, 2), "tp2"), ((2, 1), "dp2"),
                                       ((2, 1, 2), "dp2_hosts")],
                         ids=["dp1_tp2", "dp2_tp1", "dp2_tp1_hosts2"])
def test_finetune_cli_in_a_world(worlds, cli_setup, world, out):
    """The finetune CLI on every rank of a world (--tp 2, or dp = 2):
    rank 0 prints the mesh and writes a model.safetensors matching the
    one-device CLI's."""
    printed = worlds[world]["finetune_stdout"][0]
    assert f"mesh: {{'dp': {world[0]}, 'tp': {world[1]}}}" in printed
    assert "saved" in printed
    ref = load_file(str(cli_setup["dir"] / "one_device" / "model.safetensors"))
    got = load_file(str(cli_setup["dir"] / out / "model.safetensors"))
    _assert_params(got, ref)
    for name in ("config.json", "tokenizer.json"):
        assert (cli_setup["dir"] / out / name).exists()


def _step_lines(printed: str) -> list:
    """The CLI's step lines without their seconds."""
    return [line.rsplit("  ", 1)[0] for line in printed.splitlines() if line.startswith("step")]


def test_finetune_cli_across_hosts_gives_the_one_host_records(worlds, cli_setup):
    """The finetune CLI on two hosts of one rank: its step lines (loss,
    accuracies, grad norm) and its checkpoint, bit for bit, are those of
    the one-host (2, 1) world. Each host feeds shard_batch its block of the
    seeded batch (--batch-size / hosts rows), so the hosts' rows make the
    seeded batch once. The JAX CLI hands shard_batch the whole seeded
    batch as each process's rows (fish_speech_tpu/cli/finetune.py:
    194-232 with train/step.py:97-124), so on two processes its global
    batch is 2 x --batch-size with every row twice
    (test_whole_batch_as_host_rows_repeats_rows)."""
    one_host = _step_lines(worlds[(2, 1)]["finetune_stdout"][0])
    hosts = _step_lines(worlds[(2, 1, 2)]["finetune_stdout"][0])
    assert len(one_host) == 2 and hosts == one_host  # steps 0 and 2 (--log-every 10)
    a = load_file(str(cli_setup["dir"] / "dp2" / "model.safetensors"))
    b = load_file(str(cli_setup["dir"] / "dp2_hosts" / "model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_snapshot_a_host_cannot_see_raises_on_every_rank(worlds):
    """A resume whose snapshot host 1 cannot see: every rank raises at
    once, naming rank 1, its host and the path, instead of one rank
    failing and the other waiting in a collective until the timeout."""
    for rank in worlds[(2, 1, 2)]["ranks"]:
        run = rank["runs"][1]
        assert "rank(s) [1] on host(s) [1] cannot see" in run["error"]
        assert "one_device.npz" in run["error"]
        assert run["seconds"] < WORLD_TIMEOUT_S / 4


def test_tp_across_hosts_warns_and_gathers_the_batch(worlds, setup):
    """Two hosts of two ranks: a tp = 2 mesh keeps each tp group on one
    host, silently; a tp = 4 mesh crosses the hosts, which make_mesh names
    in a warning, and each rank's rows, fed its host's block, are still
    its dp block of the global batch (here all of it, dp = 1)."""
    batch = setup["batches"][0]
    for rank in worlds[(2, 2, 2)]["ranks"]:
        for probe in rank["mesh_probes"]:
            tp, place = probe["tp"], probe["placement"]
            if tp == 4:
                assert len(probe["warnings"]) == 1
                assert "tp groups [[0, 1, 2, 3]] cross hosts" in probe["warnings"][0]
            else:
                assert probe["warnings"] == []
            n = tp  # rows a dp rank: 4 rows over dp = 4 / tp
            lo = place["dp_rank"] * n
            for k, v in batch.items():
                np.testing.assert_array_equal(probe["rows"][k], v[lo:lo + n])


def test_finetune_cli_dp_fallback(worlds, cli_setup):
    """--batch-size 3 at dp = 2: rank 0 prints JAX's message and trains on
    one device."""
    printed = worlds[(2, 1)]["finetune_stdout"][1]
    assert "batch size 3 not divisible by dp=2; training on one device" in printed
    assert "mesh:" not in printed
    assert (cli_setup["dir"] / "dp_fallback" / "model.safetensors").exists()


def test_finetune_cli_tp_on_one_rank_says_so(cli_setup, capsys):
    """--tp 2 with one rank: the JAX CLI trains on one device, and so does
    the port's, saying so; the checkpoint equals the --tp 1 run's."""
    capsys.readouterr()
    tft.main(cli_setup["argv"]("one_rank_tp2", "--tp", 2))
    assert "training on one device" in capsys.readouterr().out
    a = load_file(str(cli_setup["dir"] / "one_device" / "model.safetensors"))
    b = load_file(str(cli_setup["dir"] / "one_rank_tp2" / "model.safetensors"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_finetune_cli_starts_a_rank_a_card(cli_setup, monkeypatch):
    """With several cards visible and no coordinator, the CLI starts ranks
    1..n-1 as this command (one rank a card) and joins their world as rank
    0 on nccl (the card's collectives); the launch and the join are
    recorded here, not made."""
    from fish_speech_tpu_torch.parallel import distributed as pdist

    calls = []
    monkeypatch.delenv(pdist.COORDINATOR_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(pdist, "launch_ranks",
                        lambda n, module, argv: calls.append((n, module, argv)) or ("a:1", []))

    def join(*args, **kwargs):
        calls.append((args, kwargs))
        raise RuntimeError("joined")

    monkeypatch.setattr(pdist, "initialize_distributed", join)
    argv = cli_setup["argv"]("four_cards", "--tp", 2)
    i = argv.index("--device")
    argv = argv[:i] + argv[i + 2:]  # the default, cuda
    with pytest.raises(RuntimeError, match="joined"):
        tft.main(argv)
    assert calls == [(4, "fish_speech_tpu_torch.cli.finetune", argv),
                     (("a:1", 4, 0), {"backend": None})]


@pytest.mark.parametrize("tp,batch,says", [(2, 3, "dp=2"), (4, 3, "the 2 hosts")],
                         ids=["dp", "hosts"])
def test_finetune_mesh_falls_back_where_the_batch_does_not_split(monkeypatch, capsys, tp,
                                                                 batch, says):
    """A world of two hosts of two ranks (recorded, not made): where dp,
    or the hosts, do not divide --batch-size, rank 0 says which and the
    CLI trains on one device (tp = 4 leaves dp = 1, but three rows do not
    split into two hosts' blocks)."""
    import argparse

    from fish_speech_tpu_torch.parallel import distributed as pdist

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr(pdist, "host_layout", lambda: pdist.HostLayout(0, 2, 0, 2))
    monkeypatch.setattr(pdist, "global_mesh", lambda *a: pytest.fail("built a mesh"))
    args = argparse.Namespace(tp=tp, batch_size=batch, device="cpu")
    assert tft.train_mesh(args) is None
    assert f"batch size {batch} not divisible by {says}; training on one device" in (
        capsys.readouterr().out)


class _Mesh:
    """The coords a (dp, tp) mesh gives a rank, without a world."""

    def __init__(self, dp, tp, dp_rank, tp_rank):
        self.shape, self.ranks = (dp, tp), {"dp": dp_rank, "tp": tp_rank}

    def size(self, axis=None):
        return self.shape[0] * self.shape[1] if axis is None else self.shape[axis]

    def get_local_rank(self, name):
        return self.ranks[name]


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_batch_takes_this_ranks_rows(dp):
    """shard_batch gives dp rank r block r of the rows, the same on every
    tp rank; a batch dp does not divide raises, as JAX asserts."""
    _, tb = batch_pair(JT, JC, seed=2, b=4, s=12)
    for r in range(dp):
        for t in range(2):
            got = shard_batch(tb, _Mesh(dp, 2, r, t))
            n = 4 // dp
            for k in tb:
                assert torch.equal(got[k], tb[k][r * n:(r + 1) * n])
    with pytest.raises(ValueError, match="not a multiple"):
        shard_batch({k: v[:3] for k, v in tb.items()}, _Mesh(2, 1, 0, 0))


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_shard_batch_takes_its_hosts_block(monkeypatch, hosts):
    """A (dp 4, tp 2) mesh over `hosts` hosts: each rank, fed its host's
    block of a global batch of 8 rows, keeps its dp block of the global
    batch (2 rows); a host's rows that its dp ranks do not divide raise,
    as JAX asserts."""
    from fish_speech_tpu_torch.parallel import distributed as pdist

    _, tb = batch_pair(JT, JC, seed=2, b=8, s=12)
    local, per_host = 8 // hosts, 8 // hosts
    for r in range(8):
        host = r // local
        monkeypatch.setattr(pdist, "host_layout",
                            lambda h=host, i=r % local: pdist.HostLayout(h, hosts, i, local))
        rows = {k: v[host * per_host:(host + 1) * per_host] for k, v in tb.items()}
        got = shard_batch(rows, _Mesh(4, 2, r // 2, r % 2))
        for k in tb:
            assert torch.equal(got[k], tb[k][(r // 2) * 2:(r // 2 + 1) * 2])
    if hosts < 4:
        with pytest.raises(ValueError, match="not a multiple"):
            shard_batch({k: v[:3] for k, v in tb.items()}, _Mesh(4, 2, 0, 0))


def test_whole_batch_as_host_rows_repeats_rows(monkeypatch):
    """The JAX finetune's fault, avoided in the port: handing shard_batch
    the whole seeded batch as each host's rows (fish_speech_tpu/cli/
    finetune.py:194-232) makes a global batch of B x hosts in which each
    row stands twice on two hosts; each host's block (host_rows) makes
    the seeded batch once."""
    from fish_speech_tpu_torch.parallel import distributed as pdist

    _, tb = batch_pair(JT, JC, seed=3, b=4, s=12)
    whole, blocks = [], []
    for host in range(2):
        monkeypatch.setattr(pdist, "host_layout", lambda h=host: pdist.HostLayout(h, 2, 0, 1))
        mesh = _Mesh(2, 1, host, 0)
        whole.append(shard_batch(tb, mesh)["tokens"])
        lo, hi = pdist.host_rows(4)
        blocks.append(shard_batch({k: v[lo:hi] for k, v in tb.items()}, mesh)["tokens"])
    assert torch.equal(torch.cat(whole), torch.cat([tb["tokens"], tb["tokens"]]))
    assert torch.equal(torch.cat(blocks), tb["tokens"])


@pytest.mark.parametrize("tp", [2, 4])
def test_unshard_leaf_inverts_shard_leaf(tp):
    """Every tp-split leaf of a DualAR tree whose vocab and FFN widths tp
    does not divide: the sum over the ranks of unshard_leaf(shard_leaf(x))
    is x, the ranks' parts disjoint (each shard's padding left out); a
    replicated leaf comes back whole on every rank."""
    cfg = dataclasses.replace(TC, vocab_size=97, intermediate_size=66, n_local_heads=4)
    rng = np.random.default_rng(tp)
    specs = dict(tree_leaves(lm_param_specs(cfg)))
    split = 0
    for path, shape in tree_leaves(lm_param_shapes(cfg)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        parts = [unshard_leaf(shard_leaf(x, specs[path], cfg, r, tp), specs[path], cfg, r, tp,
                              shape) for r in range(tp)]
        if not is_split(specs[path]):
            assert all(torch.equal(part, x) for part in parts), path
            continue
        split += 1
        assert (torch.stack(parts).ne(0).sum(0) == 1).all(), path
        assert torch.equal(sum(parts), x), path
    assert split == 15


def test_init_train_state_needs_the_config():
    """init_train_state(mesh=) shards by the model's specs and so needs cfg."""
    params = dual_ar_params_from_numpy(jax.tree.map(
        np.asarray, init_dual_ar_params(jax.random.PRNGKey(0), JC, dtype=jax.numpy.float32)))
    with pytest.raises(ValueError, match="model config"):
        init_train_state(params, TCFG, mesh=_Mesh(1, 2, 0, 0))
