"""``launch/paper.py`` (the paper's Fig. 2 and Fig. 4 runs) on the CPU at a
small size: every algorithm's row, its wire bits against the closed forms,
the rounds to the target, and no kernel launch (the CPU takes the plain
versions).  Imports no JAX."""
import math

import numpy as np
import pytest

from repro_torch.launch import paper

LINREG = ["linreg", "--device", "cpu", "--workers", "8", "--samples", "800",
          "--rounds", "60", "--log-every", "20"]


@pytest.mark.parametrize("extra", [[], ["--topology", "ring", "--censor"]])
def test_linreg_rows(extra, capsys):
    out = paper.run_linreg(paper.parse_args(LINREG + extra))
    rows = {r["alg"]: r for r in out["rows"]}
    assert list(rows) == ["GADMM", "Q-GADMM-2b", "Q-GADMM-4b", "GD", "QGD",
                          "ADIANA"]
    n, d = 8, 6
    assert rows["GADMM"]["bits_per_round"] == n * 32 * d
    assert rows["GD"]["bits_per_round"] == n * 32 * d + 32 * d
    assert rows["QGD"]["bits_per_round"] == n * (2 * d + 32) + 32 * d
    assert rows["ADIANA"]["bits_per_round"] == n * (32 + 4 * d) + 32 * d
    for b in (2, 4):
        r = rows[f"Q-GADMM-{b}b"]
        if extra:        # censored: the payload of each sender, a flag each
            sent = np.asarray(r["sent_per_round"], float)
            assert sent.min() < n == sent.max()
            assert r["bits_per_round"] == np.mean(sent * (b * d + 64) + n)
        else:
            assert r["bits_per_round"] == n * (b * d + 64)
    scale = out["theta_star_scale"]
    for r in out["rows"]:
        assert r["launches"] == {}
        assert math.isfinite(r["rounds_to_target"]), r["alg"]
        assert r["max_theta_err"] < 3e-2 * scale, r["alg"]
    assert "|F - F*| by round:" in capsys.readouterr().out


def test_dnn_rows():
    out = paper.run_dnn(paper.parse_args(
        ["dnn", "--device", "cpu", "--workers", "4", "--samples", "400",
         "--rounds", "3", "--local-iters", "2", "--log-every", "3"]))
    q, f = out["rows"]
    assert (q["alg"], f["alg"]) == ("Q-SGADMM", "SGADMM")
    assert q["params"] == 109_386
    assert q["bits_per_round"] == 4 * (8 * 109_386 + 64)
    assert f["bits_per_round"] == 4 * 32 * 109_386
    for r in (q, f):
        assert r["launches"] == {} and 0.0 <= r["acc"] <= 1.0
        assert [c[0] for c in r["curve"]] == [1, 3]
