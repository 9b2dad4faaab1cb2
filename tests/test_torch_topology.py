"""The port's copy of the topology tables against ``repro.core.topology``:
edges, coloring, the edge-color ports, the directed-edge index and the
exchange schedule, for the chain and every other graph; the two-tier ones
at W 2 (one cluster), 3 (the smallest with two clusters), 9 and 16."""
import numpy as np
import pytest

from repro.core import topology as jt
from repro_torch.core import topology as tt

CASES = ([("chain", w) for w in (1, 2, 3, 4, 8)]
         + [("ring", w) for w in (4, 8)]
         + [("star", w) for w in (3, 5)]
         + [("torus2d", w) for w in (4, 8)]
         + [(k, w) for k in ("cluster_of_stars", "federated")
            for w in (2, 3, 9, 16)])


@pytest.mark.parametrize("kind,w", CASES)
def test_topology_tables_match(kind, w):
    a = jt.build_topology(kind, w)
    b = tt.build_topology(kind, w)
    assert (a.kind, a.n, a.num_edges, a.num_ports) == \
        (b.kind, b.n, b.num_edges, b.num_ports)
    for f in ("edges", "color", "port", "head_mask", "degree"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    ea, eb = jt.edge_index(a), tt.edge_index(b)
    for f in ("src", "dst", "edge", "color", "slot", "sign_dst"):
        np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f),
                                      err_msg=f)
    assert jt.edge_schedule(a) == tt.edge_schedule(b)


def test_unported_kinds_raise():
    """Every kind of the JAX package builds; an unknown one raises."""
    assert tt.TOPOLOGY_KINDS == jt.TOPOLOGY_KINDS
    with pytest.raises(ValueError, match="unknown topology"):
        tt.build_topology("hypercube", 16)
    with pytest.raises(ValueError):
        tt.build_topology("ring", 3)  # odd cycle: not bipartite
