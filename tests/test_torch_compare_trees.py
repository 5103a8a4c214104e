"""velocity_asr_tpu_torch/compare_trees.py on the CPU: the turns run in
their own processes, in the order asked, and their backward outputs are
held against each other."""

import json
import os

import pytest

from velocity_asr_tpu_torch import compare_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_turns_of_one_tree_agree_bit_for_bit(capsys):
    assert compare_trees.main([ROOT, ROOT, "--device", "cpu", "--order", "ABA"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["ok"] and result["device"] == "cpu"
    assert [t["letter"] for t in result["turns"]] == ["A", "B", "A"]
    for t in result["turns"]:
        assert [b["shape"] for b in t["backward"]] == [list(s) for s in compare_trees.CPU_SHAPES]
        assert "train" not in t and all("device_ms" not in b for b in t["backward"])
        # dx, ddt, dA, dB, dC, and dh0 with a carried state
        assert [len(b["sums"]) for b in t["backward"]] == [5, 6]
    assert compare_trees._agree(result["turns"]) == 0.0


def test_an_order_naming_a_missing_tree_is_refused():
    with pytest.raises(SystemExit):
        compare_trees.main([ROOT, "--device", "cpu", "--order", "AB"])
