"""The port's multi-card dry run (`nabladft_tpu_torch/dryrun.py`), the dp×mp
grid (`parallel/dist.py`) and L-BFGS over a dp group, in a four-rank gloo
group on the CPU, against JAX's dp×mp and dp meshes and the port's n_dp=1.

The four ranks are CPU processes started once for the module (`spawn`;
tests/torch_dryrun_ranks.py, which imports no JAX, runs every scenario in
them). While they run, this process computes the same scenarios with no
group (the port's n_dp=1) and the JAX references on the 8-device virtual
mesh (tests/conftest.py); QHNet's JAX gradient, whose compile takes most
of a minute, is computed meanwhile in a process of its own. The weights are
the port's, seeded, carried to JAX with `convert.flax_params_of` (the tree
held against JAX's `model.init` evaluated abstractly). Each check is a test
of its own:

* the dry run's five phases at the JAX dry run's sizes print their ok lines
  on rank 0 and match n_dp=1 (relative 1e-6; the fit's eight epochs 1e-5);
* QHNet's and PhiSNet's matrix loss and gradients over the 2×2 grid
  against `jax.value_and_grad` over `make_mesh(n_dp=2, n_mp=2)` with the
  matrices P("dp", "mp") and QHNet's einsum path: the loss within 1e-5
  relative, each gradient tensor within 1e-5 × the tree's largest |g| and
  within 1e-4 × its own (QHNet's scalar rbf.gamma parts from JAX's by 1.9e-5
  of itself in one process, with no grid);
* `lbfgs_relax` over four dp ranks against JAX's jitted over a dp mesh of
  four, line searches "off" and "mt", with and without a rank whose share
  is all padding: nsteps and converged equal, positions within 1e-5 Å after
  3 iterations, energies within 1e-6 relative; against n_dp=1 within 1e-6;
* `multitask_loss` over the grid for every loss kind (tests/test_torch_dp.py's cases): the
  values and, summed over each dp index's mp ranks, the gradients with
  respect to the predictions are `jax.grad`'s on the whole batch (1e-6):
  a molecule count added over the whole grid would halve the energy's;
* each phase names the (B, A) of the batches its kernels ran on;
* the grid's layout (rank r at dp r // n_mp, mp r % n_mp, orbital rows
  split as `array_split`), the refusals, the dry run's group timeout (a
  job's group keeps torch's default) and a failing phase named.
"""

import datetime
import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.models import create_model as jax_create_model
from nabladft_tpu.models.base import forward as jax_forward
from nabladft_tpu.optimize.lbfgs import lbfgs_relax as jax_lbfgs_relax
from nabladft_tpu.parallel.mesh import make_mesh
from nabladft_tpu.train.losses import multitask_loss as jax_multitask_loss
from nabladft_tpu_torch import dryrun as D
from nabladft_tpu_torch.models import create_model
from nabladft_tpu_torch.models.convert import flax_params_of, load_flax_params
from nabladft_tpu_torch.parallel import dist
from nabladft_tpu_torch.train import seeded_generator
from tests import torch_dp_ranks as DP
from tests import torch_dryrun_ranks as R

pytestmark = pytest.mark.parallel

ONE_RTOL = 1e-6  # four ranks against n_dp=1, relative
FIT_RTOL = 1e-5  # the fit's eight epochs against n_dp=1
JAX_LOSS_RTOL = 1e-5
JAX_GRAD_TREE, JAX_GRAD_OWN = 1e-5, 1e-4
POS_ATOL, E_RTOL = 1e-5, 1e-6  # the relaxation against JAX: Å; relative
RANK_TIMEOUT = 300  # s, the ranks' scenarios (about 15 s)
MATRIX_SEEDS = {"qhnet": 0, "phisnet": 2}  # dryrun.PHASES' weight seeds
PHASE_OF = {"qhnet": "hamiltonian", "phisnet": "phisnet"}
# XLA's LLVM passes at -O0: the references compile in about half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def _tree_shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(np.shape(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_matrix_ref(family: str) -> dict:
    """JAX's loss and gradients (port-named) of the dry run's matrix phase
    over make_mesh(2, 2), the matrices P("dp", "mp"), on the port's weights;
    and whether those weights' tree is JAX's init tree."""
    size = D.SIZES["tiny"]
    n_dp, n_mp = D.grid_shape(R.WORLD)
    arrays = D.hamiltonian_arrays(size["ham_mols"] * n_dp, size["ham_atoms"], size["orbitals"])
    port = create_model(family, device="cpu", generator=seeded_generator(MATRIX_SEEDS[family]),
                        orbitals=size["orbitals"], **size[family])
    params = flax_params_of(port)
    extra = dict(use_pallas=False) if family == "qhnet" else {}
    model = jax_create_model(family, orbitals=size["orbitals"], **size[family], **extra)
    init = jax.eval_shape(model.init, jax.random.PRNGKey(0), JaxBatch(**arrays))
    targets = D.MATRIX_LOSSES[family]
    mesh = make_mesh(n_dp=n_dp, n_mp=n_mp)

    def loss(p, b):
        out = model.apply(p, b)
        return jax_multitask_loss(out, b, {t: "rmse_mae" for t in targets},
                                  {t: 1.0 for t in targets})["total"]

    batch = JaxBatch(**{k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P("dp", "mp") if k in targets else P("dp"))) for k, v in arrays.items()})
    sharded = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                             NamedSharding(mesh, P()))
    value, grads = _run_jitted(jax.value_and_grad(loss), sharded, batch)
    twin = load_flax_params(create_model(family, device="cpu", orbitals=size["orbitals"],
                                         **size[family]), jax.device_get(grads))
    return dict(loss=float(value), grads={n: p.detach().numpy().copy()
                                          for n, p in twin.named_parameters()},
                same_tree=_tree_shapes(init) == _tree_shapes(params))


def jax_qhnet_main(out: str) -> None:
    """QHNet's JAX reference in a process of its own (`spawn`)."""
    res = _jax_matrix_ref("qhnet")
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _jax_relax_refs() -> dict:
    """JAX's `lbfgs_relax` jitted over a dp mesh of four on the relaxation
    scenarios' batches, and whether the PaiNN weights' tree is JAX's."""
    size = D.SIZES["tiny"]
    mesh = make_mesh(n_dp=R.WORLD)
    model = jax_create_model("painn", **size["painn"])
    port = create_model("painn", device="cpu", generator=seeded_generator(1), **size["painn"])
    params = flax_params_of(port)
    first = JaxBatch(**R.relax_arrays("whole"))
    init = jax.eval_shape(model.init, jax.random.PRNGKey(0), first)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), NamedSharding(mesh, P()))

    def energy_forces(b):
        out = jax_forward(model, params, b)
        return out["energy"], out["forces"]

    out = {"same_tree": _tree_shapes(init) == _tree_shapes(flax_params_of(port))}
    for ls in R.LINE_SEARCHES:
        relax = None
        for layout in R.RELAX_LAYOUTS:
            b = JaxBatch(**{k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("dp")))
                            for k, v in R.relax_arrays(layout).items()})
            relax = relax or jax.jit(lambda b, ls=ls: jax_lbfgs_relax(
                energy_forces, b, fmax=D.RELAX["fmax"], max_steps=R.RELAX_STEPS,
                memory=D.RELAX["memory"], line_search=ls)).lower(b).compile(
                    compiler_options=FAST_COMPILE)
            res = jax.device_get(relax(b))
            out[ls, layout] = dict(pos=np.asarray(res.pos), energy=np.asarray(res.energy),
                                   converged=np.asarray(res.converged), nsteps=int(res.nsteps))
    return out


def _jax_losses() -> dict:
    """JAX's losses and gradients of the grid scenario's cases, whole batch."""
    out = {}
    for layout in DP.LOSS_LAYOUTS:
        arrays, preds = DP.loss_arrays(layout)
        batch = JaxBatch(**arrays)
        for case, (specs, coefs, max_errors) in DP.LOSS_CASES.items():
            def total(p):
                return jax_multitask_loss(p, batch, specs, coefs, max_errors)["total"]

            values = jax_multitask_loss(preds, batch, specs, coefs, max_errors)
            out[layout, case] = dict(values={k: float(v) for k, v in values.items()},
                                     grads=jax.device_get(jax.grad(total)(preds)))
    return out


def _join(procs) -> None:
    for p in procs:
        p.join(timeout=RANK_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, this process's n_dp=1 results and the JAX
    references."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("dryrun")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.rank_main, args=(r, R.WORLD, str(tmp / "store"), str(tmp)))
             for r in range(R.WORLD)]
    qhnet_out = tmp / "jax_qhnet.pkl"
    procs.append(ctx.Process(target=jax_qhnet_main, args=(str(qhnet_out),)))
    for p in procs:
        p.start()
    try:
        single_dir = tmp / "single"
        single_dir.mkdir()
        single = {name: fn(single_dir) for name, fn in R.SCENARIOS.items()
                  if name != "refusals"}
        jax_refs = dict(phisnet=_jax_matrix_ref("phisnet"), relax=_jax_relax_refs(),
                        losses=_jax_losses())
    finally:
        _join(procs)
        torch.set_num_threads(n_threads)
    assert procs[-1].exitcode == 0 and qhnet_out.exists(), "QHNet's JAX reference failed"
    with open(qhnet_out, "rb") as f:
        jax_refs["qhnet"] = pickle.load(f)
    ranks, printed = [], []
    for r in range(R.WORLD):
        path = tmp / f"rank{r}.pkl"
        assert path.exists(), f"rank {r} wrote no results (exit code {procs[r].exitcode})"
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        printed.append((tmp / f"rank{r}.out").read_text().splitlines())
    return dict(single=single, ranks=ranks, printed=printed, jax=jax_refs)


def _scenario(runs, name):
    """Each rank's results of one scenario; a rank's failure fails the test
    with its traceback."""
    out = []
    for r, res in enumerate(runs["ranks"]):
        assert name in res, f"rank {r} did not reach scenario {name!r}: {res}"
        assert "error" not in res[name], f"rank {r}, {name}:\n{res[name]['error']}"
        out.append(res[name])
    return out


def _rel_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


def _rows(ranks, key, field):
    """One field of each rank's relaxation share, the ranks' rows in order."""
    parts = sorted(((res[key]["rows"].start, res[key][field]) for res in ranks),
                   key=lambda x: x[0])
    return np.concatenate([p for _, p in parts])


def test_the_dry_run_prints_every_phase_ok_on_rank_0(runs):
    _scenario(runs, "dryrun")
    lines = [x for x in runs["printed"][0] if x.startswith("dryrun")]
    want = ("dryrun dp(4): ok", "dryrun dp×mp(2×2): ok, QHNet loss=",
            "dryrun optimize dp(4): ok", "dryrun phisnet dp×mp(2×2): ok",
            "dryrun fit dp(4): ok", "dryrun_multichip(4): ok")
    assert len(lines) == len(want) and all(x.startswith(w) for x, w in zip(lines, want)), lines
    assert "(unsharded " in lines[1] and "(unsharded " in lines[3], lines
    assert not any(runs["printed"][r] for r in range(1, R.WORLD)), runs["printed"]


def test_the_dry_run_phases_match_n_dp_1(runs):
    single = runs["single"]["dryrun"]
    for r, res in enumerate(_scenario(runs, "dryrun")):
        for name, phase in res.items():
            assert not any(phase["launches"].values()), (r, name)  # CPU tensors: no kernel
        for k in ("loss", "grad_norm"):
            _rel_close(res["train_step"][k], single["train_step"][k], ONE_RTOL, (r, k))
        for k in ("loss0", "loss1", "loss2"):
            _rel_close(res["fit"][k], single["fit"][k], FIT_RTOL, (r, k))
        assert res["fit"]["steps"] == single["fit"]["steps"] == 24
        relax, one = res["relax"], single["relax"]
        assert relax["nsteps"] == one["nsteps"] == D.RELAX["max_steps"]
        sl = relax["rows"]
        np.testing.assert_array_equal(relax["converged"], one["converged"][sl])
        _rel_close(relax["pos"], one["pos"][sl], ONE_RTOL, (r, "pos"))
        _rel_close(relax["energy"], one["energy"][sl], ONE_RTOL, (r, "energy"))


def test_the_dry_run_phases_name_their_kernel_shapes(runs):
    size, n_dp = D.SIZES["tiny"], D.grid_shape(R.WORLD)[0]
    mols, atoms, ham = (size["mols"], size["atoms"]), (size["relax_mols"], size["atoms"]), (
        size["ham_mols"], size["ham_atoms"])
    fit = [(size["fit"]["batch"], 8)]  # the fit DB's one bucket of 8 atoms
    for r, res in enumerate(_scenario(runs, "dryrun")):
        whole = [(ham[0] * n_dp, ham[1])] if r == 0 else []  # rank 0's unsharded reference
        assert {k: v["shapes"] for k, v in res.items()} == dict(
            train_step=[mols], hamiltonian=[ham] + whole, relax=[atoms], phisnet=[ham] + whole,
            fit=fit), r
    one = {k: v["shapes"] for k, v in runs["single"]["dryrun"].items()}
    w = R.WORLD
    assert one == dict(train_step=[(mols[0] * w, mols[1])], relax=[(atoms[0] * w, atoms[1])],
                       hamiltonian=[(ham[0] * n_dp, ham[1])], phisnet=[(ham[0] * n_dp, ham[1])],
                       fit=[(fit[0][0] * w, 8)]), one


@pytest.mark.parametrize("family", ["qhnet", "phisnet"])
def test_matrix_loss_and_gradients_over_the_grid_match_jax_and_n_dp_1(runs, family):
    want = runs["jax"][family]
    assert want["same_tree"], "the port's weights are not JAX's init tree"
    single = runs["single"]["dryrun"][PHASE_OF[family]]
    gmax = max(np.abs(g).max() for g in want["grads"].values())
    for r, res in enumerate(_scenario(runs, "dryrun")):
        got = res[PHASE_OF[family]]
        assert got["grid"] == (2, 2)
        assert got["loss"] == pytest.approx(want["loss"], rel=JAX_LOSS_RTOL), r
        assert got["loss"] == pytest.approx(single["loss"], rel=ONE_RTOL), r
        assert set(got["grads"]) == set(want["grads"])
        for name, g in got["grads"].items():
            w = want["grads"][name]
            err = np.abs(g - w).max()
            assert err <= JAX_GRAD_TREE * gmax, (r, name, err / gmax)
            assert err <= JAX_GRAD_OWN * np.abs(w).max() + 1e-30, (r, name)
            _rel_close(g, single["grads"][name], ONE_RTOL, (r, name, "vs n_dp=1"))


@pytest.mark.parametrize("layout", R.RELAX_LAYOUTS)
@pytest.mark.parametrize("line_search", R.LINE_SEARCHES)
def test_relaxation_over_dp_matches_jax_dp_mesh_and_n_dp_1(runs, line_search, layout):
    key = (line_search, layout)
    assert runs["jax"]["relax"]["same_tree"]
    want, single = runs["jax"]["relax"][key], runs["single"]["relax"][key]
    ranks = _scenario(runs, "relax")
    assert {res[key]["nsteps"] for res in ranks} == {want["nsteps"]} == {single["nsteps"]}
    converged = _rows(ranks, key, "converged")
    np.testing.assert_array_equal(converged, want["converged"])
    np.testing.assert_array_equal(converged, single["converged"])
    pos, energy = _rows(ranks, key, "pos"), _rows(ranks, key, "energy")
    np.testing.assert_allclose(pos, want["pos"], rtol=0, atol=POS_ATOL)
    _rel_close(energy, want["energy"], E_RTOL, "energy vs JAX")
    _rel_close(pos, single["pos"], ONE_RTOL, "pos vs n_dp=1")
    _rel_close(energy, single["energy"], ONE_RTOL, "energy vs n_dp=1")
    assert np.abs(pos - R.relax_arrays(layout)["pos"]).max() > 1e-3  # the atoms moved
    if layout == "pad":  # the last rank relaxed padding alone, in step with the others
        assert ranks[-1][key]["rows"] == slice(6, 8) and converged[-2:].sum() == 0


@pytest.mark.parametrize("layout", list(DP.LOSS_LAYOUTS))
@pytest.mark.parametrize("case", list(DP.LOSS_CASES))
def test_grid_losses_match_jax_on_the_whole_batch(runs, layout, case):
    ranks = [res[layout, case] for res in _scenario(runs, "grid")]
    want = runs["jax"]["losses"][layout, case]
    for r, res in enumerate(ranks):
        assert set(res["values"]) == set(want["values"])
        for k, v in want["values"].items():
            assert res["values"][k] == pytest.approx(v, rel=ONE_RTOL), (r, k)
    for k, g in want["grads"].items():
        parts = []
        for d in range(2):  # a dp index's gradient: the sum over its mp ranks
            mine = [res for r, res in enumerate(ranks) if r // 2 == d and k in res["grads"]]
            if mine:
                parts.append(sum(res["grads"][k] for res in mine))
        _rel_close(np.concatenate(parts) if parts else np.zeros_like(g), g, ONE_RTOL, k)


def test_the_grid_lays_ranks_out_as_make_mesh(runs):
    for r, res in enumerate(_scenario(runs, "grid")):
        assert res["place"] == (r // 2, r % 2, 2, 2)
        for layout in DP.LOSS_LAYOUTS:
            assert res["orbital_rows", layout] == (slice(0, 6) if r % 2 == 0 else slice(6, 12))
            assert res[layout, "rmse_mae"]["rows"] == (slice(0, 3) if r < 2 else slice(3, 5))
    assert runs["single"]["grid"]["place"] is None


def test_a_grid_that_does_not_fit_the_world_is_refused(runs):
    for res in _scenario(runs, "refusals"):
        assert "n_mp=3" in res["n_mp"] and "world size 4" in res["n_mp"], res
        assert "n_dp=3" in res["n_dp"] and "n_mp=2" in res["n_dp"], res
        assert "world size 4" in res["n_dp"], res


def _started_group(monkeypatch, **kw) -> dict:
    """The arguments `init_from_env(cpu, **kw)` gives `init_process_group`
    under a launcher's environment."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **a: seen.update(a, backend=backend))
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    assert dist.init_from_env(torch.device("cpu"), **kw)
    return seen


def test_init_from_env_starts_the_group_with_the_timeout(monkeypatch):
    seen = _started_group(monkeypatch, timeout=dist.TIMEOUT)
    assert seen == dict(backend="gloo", rank=0, world_size=1, timeout=dist.TIMEOUT)
    assert dist.TIMEOUT <= datetime.timedelta(seconds=120)


def test_a_jobs_group_keeps_torchs_default_timeout(monkeypatch):
    assert _started_group(monkeypatch) == dict(backend="gloo", rank=0, world_size=1)


def test_the_dry_runs_launcher_entry_starts_its_group_with_the_timeout(monkeypatch):
    calls = []
    monkeypatch.setattr(D.dist, "init_from_env",
                        lambda device, **kw: calls.append((device, kw)) or False)
    monkeypatch.setattr(D, "entry", lambda device: (lambda m, b: {}, (None, None)))
    monkeypatch.setattr(D, "dryrun_multichip", lambda n, size, device: calls.append((n, size)))
    assert D.main(["--size", "tiny", "--device", "cpu"]) == 0
    assert calls == [(torch.device("cpu"), dict(timeout=dist.TIMEOUT)), (1, "tiny")]


def test_a_failing_phase_is_named(monkeypatch, tmp_path):
    def hung(*args):
        raise RuntimeError("a collective timed out")

    monkeypatch.setattr(D, "PHASES", {"train_step": D.PHASES["train_step"], "relax": hung})
    with pytest.raises(RuntimeError, match="dryrun phase 'relax' failed on rank 0 of 1"):
        D.dryrun_multichip(1, "tiny", "cpu", workdir=tmp_path)


def test_the_full_sizes_are_the_configs_widths():
    from pathlib import Path

    from nabladft_tpu_torch.config import load_config

    configs = Path(__file__).resolve().parents[1] / "configs"
    full = D.SIZES["full"]
    for config, key in (("painn-oc", "painn"), ("painn-oc_optim", "painn"),
                        ("painn-oc", "fit_painn"), ("qhnet", "qhnet"), ("phisnet", "phisnet")):
        cfg = load_config(configs / f"{config}.yaml")
        assert cfg["model"]["kwargs"] == full[key], (config, key)
    painn_oc = load_config(configs / "painn-oc.yaml")
    assert full["fit"]["losses"] == painn_oc["model"]["loss_specs"] == D.STEP["loss_specs"]
