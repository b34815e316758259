"""The reference's production plan and ``compressed_psum``, dumped for
``test_torch_sharding.py``.  Run as a script, in a process of its own
(512 forced host devices must be set before JAX starts):

    python tests/_plan_reference.py OUT_DIR

Writes ``OUT_DIR/plan.json``: for every cell of ``all_cells()`` on both
production meshes (and the ``opt2`` cells ``OPT2``) the leaves of
``build_cell``'s arguments (path, shape, dtype, ``PartitionSpec``,
``NamedSharding.shard_shape``) and ``meta``; for the reduced configs of
``REDUCED`` on both meshes, ``param_shardings``'s spec of each parameter.
With ``OUT_DIR/psum_in.npz`` present (arrays stacked on a leading axis of
4), also ``OUT_DIR/psum_out.npz``: ``compressed_psum`` of each over a
4-device ``('pod',)`` mesh, as float32.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import all_cells, get_reduced  # noqa: E402
from repro.distributed import ctx  # noqa: E402
from repro.distributed.compression import compressed_psum  # noqa: E402
from repro.distributed.sharding import param_shardings  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.launch.specs import _eval_params, build_cell  # noqa: E402
from repro.models.recsys import init_din  # noqa: E402
from repro.models.transformer import init_lm_params  # noqa: E402

OPT2 = (("olmoe-1b-7b", "train_4k"), ("gat-cora", "full_graph_sm"))
REDUCED = ("olmoe-1b-7b", "deepseek-v3-671b", "din")


def _key(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
        else:
            parts.append(str(p))
    return "/".join(parts)


def _spec(ps) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in ps]


def _leaves(args, shardings) -> list:
    la = jax.tree_util.tree_flatten_with_path(args)[0]
    ls = jax.tree_util.tree_flatten_with_path(shardings)[0]
    if [_key(p) for p, _ in la] != [_key(p) for p, _ in ls]:
        raise AssertionError("arguments and shardings do not pair up")
    return [[_key(p), list(a.shape), str(a.dtype), _spec(s.spec),
             list(s.shard_shape(a.shape))]
            for (p, a), (_, s) in zip(la, ls)]


def main(out_dir: str) -> None:
    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    cells = {}
    todo = [(a, s, "baseline") for a, s in all_cells()]
    todo += [(a, s, "opt2") for a, s in OPT2]
    for a, s, variant in todo:
        for mk, mesh in meshes.items():
            cell = build_cell(a, s, mesh, variant=variant)
            cells[f"{a}|{s}|{mk}|{variant}"] = dict(
                meta={k: int(v) for k, v in cell.meta.items()},
                leaves=_leaves(cell.arg_specs, cell.in_shardings))
            ctx.reset()
    reduced = {}
    for a in REDUCED:
        cfg = get_reduced(a)
        if cfg.family == "lm":
            p, fam = _eval_params(init_lm_params, cfg), "lm"
        else:
            p, fam = _eval_params(lambda k: init_din(k, cfg)), "recsys"
        for mk, mesh in meshes.items():
            reduced[f"{a}|{mk}"] = _leaves(p, param_shardings(p, fam, mesh))
    with open(os.path.join(out_dir, "plan.json"), "w") as f:
        json.dump(dict(cells=cells, reduced=reduced), f)

    src = os.path.join(out_dir, "psum_in.npz")
    if os.path.exists(src):
        mesh = compat.make_mesh((4,), ("pod",),
                                axis_types=compat.default_axis_types(1),
                                devices=jax.devices()[:4])
        out = {}
        with np.load(src) as d:
            for name in d.files:
                x = jnp.asarray(d[name])
                if name.startswith("bf16"):
                    x = x.astype(jnp.bfloat16)
                xs = jax.device_put(x, NamedSharding(
                    mesh, P("pod", *([None] * (x.ndim - 1)))))
                got = compressed_psum(xs, "pod", mesh)
                out[name] = np.asarray(got.astype(jnp.float32))
        np.savez(os.path.join(out_dir, "psum_out.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])
