"""Shared inputs of the GNN-path tests (segment_spmm and the four GNN
forwards): the sweep shapes of ``tests/test_kernels.py``, the edge cases,
and one seeded graph, all drawn with numpy, so the CPU parity tests and
the card-only tests feed the same numbers.  Imports no JAX."""
import numpy as np

# (E, N, D, tn, te) of test_segment_spmm_sweep; tn/te tile the
# reference's Pallas pipeline and mean nothing to the port
SPMM_SWEEP = [(300, 50, 8, 16, 64), (1000, 128, 32, 32, 128),
              (64, 7, 4, 8, 32)]
SPMM_TOL = 1e-5
# gat_aggregate with bf16 anywhere, on the card: each element within 3 bf16
# steps of its row's sum of |msg| (a weight's rounding can go the other way
# after a denominator one step off, and the message's with it)
GAT_BF16_TOL = 3 * 2.0 ** -7
SPMM_EDGE_CASES = ["d1", "d75", "no_edges", "empty_rows", "one_node",
                   "masked"]

GNN_ARCHS = ["graphcast", "schnet", "pna", "gat-cora"]
# the graph of tests/test_arch_smoke.py::test_gnn_smoke, with 10% of the
# edge slots masked
N_NODES, N_EDGES, D_FEAT, N_OUT = 40, 160, 12, 7
MASKED_SHARE = 0.1


def sweep_inputs(E, N, D):
    """The reference sweep's draw: msgs (E, D) float32, dst (E,) int32."""
    rng = np.random.default_rng(E + N)
    msgs = rng.normal(size=(E, D)).astype(np.float32)
    dst = rng.integers(0, N, E).astype(np.int32)
    return msgs, dst


def edge_inputs(case):
    """``(msgs (E, D) float32, dst (E,) int32, n)`` for one edge case:
    D = 1 and D = 75 (no 16-byte vectors), no edges at all, half the
    nodes with no in-edge, every edge on one node, and 30% of the
    messages zeroed by a mask, as the models zero masked slots."""
    rng = np.random.default_rng(len(case))
    E, n, D = {"d1": (200, 30, 1), "d75": (500, 40, 75),
               "no_edges": (0, 5, 8), "empty_rows": (100, 60, 16),
               "one_node": (1000, 10, 16), "masked": (300, 50, 8)}[case]
    msgs = rng.normal(size=(E, D)).astype(np.float32)
    dst = rng.integers(0, n, E).astype(np.int32)
    if case == "empty_rows":
        dst = 2 * rng.integers(0, n // 2, E).astype(np.int32)
    elif case == "one_node":
        dst[:] = 3
    elif case == "masked":
        msgs *= (rng.random(E) >= 0.3).astype(np.float32)[:, None]
    return msgs, dst, n


def graph_arrays(kind, seed=0):
    """One GraphBatch's fields for a model of ``kind``, as numpy arrays:
    N_NODES nodes with D_FEAT features, N_EDGES edge slots of which
    MASKED_SHARE are masked, labels of the model's kind, positions."""
    rng = np.random.default_rng(seed)
    N, E = N_NODES, N_EDGES
    if kind == "graphcast":
        labels = rng.normal(size=(N, 8)).astype(np.float32)
    elif kind == "schnet":
        labels = rng.normal(size=N).astype(np.float32)
    else:
        labels = rng.integers(0, N_OUT, N).astype(np.int32)
    return dict(
        node_feats=rng.normal(size=(N, D_FEAT)).astype(np.float32),
        edge_src=rng.integers(0, N, E).astype(np.int32),
        edge_dst=rng.integers(0, N, E).astype(np.int32),
        edge_mask=rng.random(E) >= MASKED_SHARE,
        labels=labels, label_mask=np.ones(N, bool),
        positions=(2.0 * rng.normal(size=(N, 3))).astype(np.float32))


# GAT graphs beyond the seeded one: "hub" adds HUB_SLOTS live-or-masked
# slots into node 5, above the kernel's hub threshold (HUB_DEGREE = 128),
# so the card splits that row; the reference's bfloat16 segment sums
# under gnn_bf16_msgs drift as the in-degree grows (ROADMAP C3), so the
# hub stays just above the threshold.  "all_masked" adds ALL_MASKED_SLOTS
# slots into node 9 and masks every slot into it.
GAT_GRAPHS = ["hub", "all_masked"]
HUB_NODE, HUB_SLOTS = 5, 150
ALL_MASKED_NODE, ALL_MASKED_SLOTS = 9, 6
GAT_HEAD_SHAPES = [(2, 4), (8, 8), (8, 7)]   # reduced, full layers 1 and 2


def gat_graph_arrays(case, seed=0):
    """``graph_arrays("gat")`` with the extra slots of ``case``."""
    arrays = graph_arrays("gat", seed)
    rng = np.random.default_rng(seed + 1)
    node, k = {"hub": (HUB_NODE, HUB_SLOTS),
               "all_masked": (ALL_MASKED_NODE, ALL_MASKED_SLOTS)}[case]
    src = rng.integers(0, N_NODES, k).astype(np.int32)
    arrays["edge_src"] = np.concatenate([arrays["edge_src"], src])
    arrays["edge_dst"] = np.concatenate([arrays["edge_dst"],
                                         np.full(k, node, np.int32)])
    arrays["edge_mask"] = np.concatenate([arrays["edge_mask"],
                                          rng.random(k) >= MASKED_SHARE])
    if case == "all_masked":
        arrays["edge_mask"][arrays["edge_dst"] == node] = False
    return arrays


def gat_kernel_inputs(H, dout, seed=0, N=300, E=6000, hub=600,
                      zero_scores=False):
    """Inputs of one ``gat_aggregate`` as float32 numpy arrays: hw (N, H,
    dout), s_src, s_dst (N, H), and src, dst (E + hub,) int32, mask bool:
    E uniform slots, 10% masked, and ``hub`` slots into node 5 (above
    the threshold); node 7 has no in-edge, every slot into node 9 is
    masked.  ``zero_scores``: every tenth slot a self-loop and ``s_dst =
    -s_src``, so those slots' pre-activations are exactly 0, where
    leaky_relu's slope is 1."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E + hub).astype(np.int32)
    dst = np.concatenate([rng.integers(0, N, E),
                          np.full(hub, HUB_NODE)]).astype(np.int32)
    dst[dst == 7] = 8
    mask = rng.random(E + hub) >= MASKED_SHARE
    mask[dst == ALL_MASKED_NODE] = False
    x = dict(hw=rng.normal(size=(N, H, dout)).astype(np.float32),
             s_src=rng.normal(size=(N, H)).astype(np.float32),
             s_dst=rng.normal(size=(N, H)).astype(np.float32),
             src=src, dst=dst, mask=mask)
    if zero_scores:
        src[::10] = dst[::10]
        x["s_dst"] = -x["s_src"]
    return x
