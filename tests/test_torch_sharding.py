"""The port's production mesh plan (``launch/mesh.py``,
``distributed/sharding.py``, ``launch/specs.py``, ``launch/dryrun.py``)
and ``compressed_psum`` against the reference.

The reference's side runs in one process of its own with 512 forced host
devices (``tests/_plan_reference.py``), started with the module beside
the dry-run's two CLI runs; the port plans in a fake world of 256 or 512
ranks in this process, and the collectives run on spawned gloo ranks.
"""
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from _dist_rank import placement_rank_main, psum_rank_main, spawn_ranks
from repro_torch.configs import all_cells, get_config, get_reduced
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (dp_entry, lm_param_spec,
                                              param_shardings)
from repro_torch.launch.mesh import (make_engine_mesh, make_mesh,
                                     make_production_mesh, plan_world)
from repro_torch.launch import specs
from repro_torch.launch.specs import arg_bytes, build_cell
from repro_torch.models.gnn import STACKED_KINDS
from repro_torch.models.recsys import DINModel, init_din
from repro_torch.models.transformer import init_lm_params

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
MESHES = ("single", "multi")
OPT2 = (("olmoe-1b-7b", "train_4k"), ("gat-cora", "full_graph_sm"))
PAIRS = ([(a, s, m, "baseline") for a, s in all_cells() for m in MESHES]
         + [(a, s, m, "opt2") for a, s in OPT2 for m in MESHES])
# reduced configs with dims the production meshes do not divide
REDUCED = ("olmoe-1b-7b", "deepseek-v3-671b", "din")
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k"), ("olmoe-1b-7b", "decode_32k"))
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4, "bool": 1}
PSUM_SEED = 2026
PSUM_TOL = 0.05          # tests/test_multidevice.py's compressed_psum bound


def psum_cases() -> dict:
    """compressed_psum's inputs, stacked on a leading axis of 4 ranks:
    several shapes and scales, all zeros (the 1e-12 floor of the scale),
    and one cast to bfloat16."""
    rng = np.random.default_rng(PSUM_SEED)
    cases = {f"f32_4096_s{s}": (rng.standard_normal((4, 4096)) * s
                                ).astype(np.float32)
             for s in (0.01, 1.0, 100.0)}
    cases["f32_3x5x7"] = rng.standard_normal((4, 3, 5, 7)).astype(np.float32)
    cases["zeros"] = np.zeros((4, 64), np.float32)
    cases["bf16_1024"] = rng.standard_normal((4, 1024)).astype(np.float32)
    return cases


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def background():
    """Start the reference's dump and the dry-run CLI runs at once; each
    fixture below waits for its own."""
    with tempfile.TemporaryDirectory() as tmp:
        ref_dir = os.path.join(tmp, "ref")
        os.makedirs(ref_dir)
        np.savez(os.path.join(ref_dir, "psum_in.npz"), **psum_cases())
        procs = {"ref": subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_plan_reference.py"),
             ref_dir], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
        for arch, shape in DRYRUN_CELLS:
            art = os.path.join(tmp, f"dryrun_{arch}_{shape}")
            procs[arch, shape] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "single"],
                env=dict(_env(), DRYRUN_ARTIFACTS=art),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            yield tmp, procs
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.communicate()


def _wait(proc, timeout: float = 240.0) -> str:
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.fixture(scope="module")
def ref(background):
    tmp, procs = background
    _wait(procs["ref"])
    ref_dir = os.path.join(tmp, "ref")
    with open(os.path.join(ref_dir, "plan.json")) as f:
        plan = json.load(f)
    with np.load(os.path.join(ref_dir, "psum_out.npz")) as d:
        plan["psum"] = {k: d[k] for k in d.files}
    return plan


# --------------------------------------------------------------------------- #
# (a) the plan against the reference's
# --------------------------------------------------------------------------- #
def _norm_spec(spec) -> tuple:
    """A spec with 1-tuples as their axis, trailing Nones dropped."""
    out = []
    for e in spec:
        if isinstance(e, (list, tuple)):
            e = tuple(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_key(cfg, i: int, name: str):
    """The reference's leaf path of the port's leaf ``name`` of argument
    ``i``, and its index on the reference's layer axis (None where the
    reference does not stack it)."""
    parts = name.split(".") if name else []
    pre = []
    if parts[:1] in (["mu"], ["nu"]):
        pre, parts = parts[:1], parts[1:]
    if parts[:1] == ["net"]:                  # GNNModel's ParamTree
        parts = parts[1:]
    layer = None
    if cfg.family == "lm" and parts[:1] == ["blocks"]:
        j = int(parts[1])
        n_dense = cfg.moe.first_k_dense if cfg.moe else cfg.n_layers
        layer = j if j < n_dense else j - n_dense
        parts = ["dense_stack" if j < n_dense else "moe_stack", *parts[2:]]
    elif (cfg.family == "gnn" and cfg.kind in STACKED_KINDS
          and parts[:1] == ["layers"]):
        layer, parts = int(parts[1]), ["layers", *parts[2:]]
    return "/".join([str(i), *pre, *parts]), layer


def _port_plan(arch, shape, mesh_kind, variant):
    """(meta, argument bytes, leaves grouped by the reference's path)."""
    cfg = get_config(arch).model
    groups = {}
    with plan_world(512 if mesh_kind == "multi" else 256):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        cell = build_cell(arch, shape, mesh, variant=variant)
        nbytes = arg_bytes(cell)
        memo = {}
        for i, name, t, sh in cell.leaves():
            key, layer = _ref_key(cfg, i, name)
            groups.setdefault(key, []).append(
                (layer, tuple(t.shape), str(t.dtype).split(".")[-1],
                 _norm_spec(sh.spec), sh.local_shape(t.shape, t.dtype, memo)))
    return cell.meta, nbytes, groups


@pytest.mark.parametrize("arch,shape,mesh_kind,variant", PAIRS)
def test_plan_matches_reference(ref, arch, shape, mesh_kind, variant):
    want = ref["cells"][f"{arch}|{shape}|{mesh_kind}|{variant}"]
    meta, nbytes, groups = _port_plan(arch, shape, mesh_kind, variant)
    assert meta == want["meta"]
    assert nbytes["total"] == sum(math.prod(lf[4]) * ITEMSIZE[lf[2]]
                                  for lf in want["leaves"])
    for key, shape_, dtype, spec, shard in want["leaves"]:
        got = sorted(groups.pop(key), key=lambda g: g[0] or 0)
        if got[0][0] is None:           # one tensor in both
            expect = [(None, tuple(shape_), dtype, _norm_spec(spec),
                       tuple(shard))]
        else:                           # a stack of per-layer tensors
            assert not spec or spec[0] is None, (key, spec)
            expect = [(j, tuple(shape_[1:]), dtype, _norm_spec(spec[1:]),
                       tuple(shard[1:])) for j in range(shape_[0])]
        assert got == expect, key
    assert not groups, sorted(groups)


# --------------------------------------------------------------------------- #
# (b) dims the mesh does not divide
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("mesh_kind", MESHES)
def test_reduced_config_drops_axes_that_do_not_divide(ref, arch, mesh_kind):
    cfg = get_reduced(arch)
    with plan_world(512 if mesh_kind == "multi" else 256):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        if cfg.family == "lm":
            model, fam = init_lm_params(None, cfg, "meta"), "lm"
        else:
            model, fam = DINModel(cfg, init_din(None, cfg, "meta")), "recsys"
        params = dict(model.named_parameters())
        got = param_shardings(params, fam, mesh)
        rule = {n: (lm_param_spec(n, t.ndim, dp_entry(mesh)) if fam == "lm"
                    else ((tuple(mesh.mesh_dim_names), None)
                          if "table" in n and t.ndim == 2 else ()))
                for n, t in params.items()}
    groups = {}
    for name in params:
        groups.setdefault(_ref_key(cfg, 0, name)[0], set()).add(
            _norm_spec(got[name].spec))
    for key, _, _, spec, _ in ref["reduced"][f"{arch}|{mesh_kind}"]:
        stacked = key.split("/")[0] in ("dense_stack", "moe_stack")
        assert groups.pop(f"0/{key}") == {
            _norm_spec(spec[1:] if stacked else spec)}, key
    assert not groups, sorted(groups)
    # the case exercises the fallback: some rule's axis was dropped
    assert any(_norm_spec(rule[n]) != _norm_spec(got[n].spec)
               for n in params)


# --------------------------------------------------------------------------- #
# (c) compressed_psum
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def psum_ranks():
    return spawn_ranks(psum_rank_main, 4, (psum_cases(),), timeout_s=180.0)


@pytest.mark.parametrize("case", list(psum_cases()))
def test_compressed_psum_matches_reference_bit_for_bit(ref, psum_ranks, case):
    x = psum_cases()[case]
    want = ref["psum"][case]
    for rank, out in enumerate(psum_ranks):
        got = out[case]
        assert got.shape == x.shape[1:]
        # every row of the reference's result is the sum
        assert np.array_equal(got.view(np.uint32), want[rank].view(np.uint32))
    xs = x.astype(np.float32)
    if case.startswith("bf16"):
        xs = torch.from_numpy(xs).bfloat16().float().numpy()
    exact = xs.astype(np.float64).sum(0)
    err = np.abs(psum_ranks[0][case] - exact).max()
    assert err <= PSUM_TOL * max(np.abs(exact).max(), 1e-30)


# --------------------------------------------------------------------------- #
# (d) placements on a real (gloo) mesh
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def placement_ranks():
    return spawn_ranks(placement_rank_main, 2, ("qwen3-4b", 0),
                       timeout_s=180.0)


@pytest.mark.parametrize("rank", [0, 1])
def test_placement_round_trip(placement_ranks, rank):
    cfg = get_reduced("qwen3-4b")
    with plan_world(2):
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        params = dict(init_lm_params(None, cfg, "meta").named_parameters())
        memo = {}
        plan = sum(math.prod(s.local_shape(params[n].shape, params[n].dtype,
                                           memo)) * params[n].element_size()
                   for n, s in param_shardings(params, "lm", mesh).items())
    out = placement_ranks[rank]
    assert out["n_split"] > 0 and out["n_params"] == len(params)
    assert out["local_bytes"] == plan
    assert out["differ"] == []


def test_mesh_functions_refuse_bad_worlds():
    with plan_world(4):
        with pytest.raises(RuntimeError, match="topology mismatch"):
            make_engine_mesh(8, device_type="cpu")
        assert make_engine_mesh(device_type="cpu").mesh_dim_names == ("data",)
        with pytest.raises(RuntimeError, match="already initialised"):
            with plan_world(2):
                pass


class _LossReached(Exception):
    pass


@pytest.mark.parametrize("variant", ["baseline", "opt", "opt2", "opt3"])
def test_variant_flags_hold_only_inside_the_cell(monkeypatch, variant):
    """A variant's flags select its specs and hold while its step runs;
    the caller's own flags come back after the build and after the
    step."""
    seen = {}

    def loss(params, cfg, batch):
        seen.update(vars(ctx.CURRENT))
        raise _LossReached

    monkeypatch.setattr(specs, "gnn_loss", loss)
    ctx.set_flags(moe_capacity_factor=2.0)
    try:
        mine = ctx.CURRENT
        with plan_world(256):
            mesh = make_production_mesh(device_type="cpu")
            cell = build_cell("gat-cora", "full_graph_sm", mesh,
                              variant=variant)
        assert ctx.CURRENT is mine and not mine.gnn_bf16_msgs
        replicate = variant in ("opt2", "opt3")
        assert (cell.placements[2]["node_feats"].spec == ()) == replicate
        with pytest.raises(_LossReached):
            cell.fn(*cell.arg_specs)
        assert ctx.CURRENT is mine and mine.moe_capacity_factor == 2.0
    finally:
        ctx.reset()
    assert seen["gnn_bf16_msgs"] == (variant != "baseline")
    assert seen["gnn_replicate_nodes"] == replicate
    assert seen["moe_tp"] == (variant == "opt2")
    assert seen["moe_capacity_factor"] == (1.0 if variant == "opt3" else None)


# --------------------------------------------------------------------------- #
# (e) the dry-run entry point
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS)
def test_dryrun_entry_point(background, ref, arch, shape):
    tmp, procs = background
    out = _wait(procs[arch, shape])
    assert "all dry-runs passed" in out
    path = os.path.join(tmp, f"dryrun_{arch}_{shape}",
                        f"dryrun_{arch}_{shape}_single.json")
    with open(path) as f:
        rec = json.load(f)
    want = ref["cells"][f"{arch}|{shape}|single|baseline"]
    assert rec["ok"] and rec["step_check"] == "ok"
    assert rec["flops_global_step"] > 0
    assert rec["collectives"] is None
    assert rec["meta"] == want["meta"]
    assert rec["arg_bytes_per_device"]["total"] == sum(
        math.prod(lf[4]) * ITEMSIZE[lf[2]] for lf in want["leaves"])
