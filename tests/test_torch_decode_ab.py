"""The decode A/B tool (``tools/decode_ab.py``) on the CPU: its
geometries, its verdict over the four runs, its output check and its exit
code without a card.  The timing itself runs on the card only."""

import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.tools import decode_ab as A


def _runs(parent, change, digests=("a", "a", "a", "a")):
    """Four runs in ``A.ORDER`` of one geometry: parent, change, change,
    parent."""
    us = [parent[0], change[0], change[1], parent[1]]
    return [{"card": "x", "results": {"g": {"us": u, "min_us": u,
                                             "max_us": u, "sha1": d}}}
            for u, d in zip(us, digests)]


def test_geometries_cover_every_mode_and_both_wires():
    names = {A.geometry_name(k, S.mode_for(key).name, m, w)
             for k, key, m, w in A.GEOMETRIES}
    assert len(names) == len(A.GEOMETRIES) == 16
    for kernel in ("rgb", "ycbcr"):
        for key in S.MODES:
            assert (f"{kernel} {S.mode_for(key).name} M=16384 int8"
                    in names)
        for m in (16384, 196608):
            assert f"{kernel} 4:2:0 M={m} int16" in names
        assert f"{kernel} 4:2:0 M=196608 int8" in names


@pytest.mark.parametrize("parent, change, word", [
    ((20.0, 20.2), (15.0, 15.1), "faster"),
    ((15.0, 15.1), (20.0, 20.2), "slower"),
    ((20.0, 21.0), (20.2, 20.3), "within band"),
    # The gap (0.5) is smaller than the parent's own spread (1.0).
    ((20.0, 21.0), (19.4, 19.5), "within band"),
])
def test_verdict_needs_a_gap_beyond_the_band(parent, change, word):
    row = A.verdict(_runs(parent, change))["g"]
    assert row["verdict"] == word
    assert row["parent_us"] == list(parent)
    assert row["change_us"] == list(change)
    assert row["band_us"] == pytest.approx(max(parent[1] - parent[0],
                                               change[1] - change[0]))
    assert row["speedup"] == pytest.approx(sum(parent) / sum(change))


def test_differing_outputs_are_named():
    assert A.digests_agree(_runs((1, 1), (1, 1))) == []
    assert A.digests_agree(_runs((1, 1), (1, 1),
                                 ("a", "b", "a", "a"))) == ["g"]


def test_exits_2_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    assert A.main(["--root", A.HERE_ROOT]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_one_side_is_required():
    with pytest.raises(SystemExit):
        A.main([])
