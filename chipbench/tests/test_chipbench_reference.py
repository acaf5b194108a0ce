"""The frozen reference against hand computations, and what it imports."""
import ast
import math

import pytest
import torch

from chipbench import harness
from chipbench.references import cnn_eq as ref

# two layers, K 3, strides (2, 1), C 1 -> 1 -> 2: w1 = [-1, 0, 1], b1 =
# 0.5; w2 = [[1, 1, 1], [0, 1, 0]], b2 = [0, -1]
W1 = torch.tensor([[[[-1.0, 0.0, 1.0]]]])
B1 = torch.tensor([[0.5]])
W2 = torch.tensor([[[[1.0, 1.0, 1.0]], [[0.0, 1.0, 0.0]]]])
B2 = torch.tensor([[0.0, -1.0]])
X = torch.arange(1.0, 9.0)                       # 8 samples: 4 positions


def by_hand():
    # padded by half a receptive field, 1 + 2 = 3 zeros on the left and up
    # to the last window (13 samples) on the right
    xp = [0, 0, 0] + X.tolist() + [0, 0]
    h = [max(0.0, xp[2 * p + 2] - xp[2 * p] + 0.5) for p in range(6)]
    ch0 = [h[q] + h[q + 1] + h[q + 2] for q in range(4)]
    ch1 = [h[q + 1] - 1.0 for q in range(4)]
    return [v for pair in zip(ch0, ch1) for v in pair]


@pytest.mark.parametrize("datapath", [
    {"kind": "float", "operand": "float32"},
    # every weight and activation sits on its grid: the integer path is
    # the same numbers
    {"kind": "int", "formats": [[2, 5, 4, 3], [2, 5, 4, 3]]}])
def test_two_layer_stream_by_hand(datapath):
    layers = [(W1, B1), (W2, B2)]
    want = by_hand()
    assert want == [5.5, 1.5, 7.5, 1.5, 7.5, 1.5, 5.0, 1.5]
    got = ref.equalize_stream(X, layers, [2, 1], datapath, block=3)
    assert got.tolist() == want
    rows = ref.equalize_rows(torch.stack([X, X]), layers, [2, 1], datapath,
                             torch.tensor([0, 0]), block=1)
    assert rows.tolist() == [want, want]


def test_int_grid_rounds_half_to_even_and_saturates():
    v = torch.tensor([0.3125, 0.4375, 100.0, -100.0])    # 2.5, 3.5 at 2^3
    assert ref._grid(v, 0, 3).tolist() == [2.0, 4.0, 7.0, -8.0]


def test_fold_by_hand():
    raw = {"w": [torch.ones(1, 1, 1, 2), torch.ones(1, 1, 1, 2)],
           "b": [torch.tensor([[1.0]]), torch.tensor([[1.0]])],
           "gamma": [torch.tensor([[2.0]])], "beta": [torch.tensor([[0.25]])],
           "mean": [torch.tensor([[0.5]])], "var": [torch.tensor([[3.0]])]}
    (w1, b1), (w2, b2) = ref.fold(raw)
    g = 2.0 / math.sqrt(3.0 + 1e-5)
    assert w1.flatten().tolist() == pytest.approx([g, g], rel=1e-7)
    assert b1.item() == pytest.approx(0.5 * g + 0.25, rel=1e-7)
    assert w2.flatten().tolist() == [1.0, 1.0] and b2.item() == 1.0


def test_lower_precision_is_one_step_down():
    assert ref.lower_precision({"kind": "int", "formats": [[1, 6, 3, 4]]}) \
        == {"kind": "int", "formats": [[1, 2, 3, 0]]}
    assert ref.lower_precision({"kind": "float", "operand": "bfloat16"}) \
        == {"kind": "float", "operand": "float8_e4m3fn"}


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((harness.HERE / "references" / "cnn_eq.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "typing", "torch", "math", "numpy"}, names
