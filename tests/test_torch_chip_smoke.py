"""chip_smoke.py's contract where there is no card, and its bound arithmetic.

The script must exit non-zero and print no result line when CUDA is absent,
from the repo root and from a directory that holds nothing else of the repo.
Its least-time bounds and the forward's operation count (for its TFLOP/s)
are checked against hand-counted bytes and operations at GPT-2 124M's
attention shape.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_cuda(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run(
        [sys.executable, str(script)],
        cwd=script.parent,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_attention_bounds_at_gpt2_shape():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, D = chip_smoke.SLICE_ATTN
    bounds = chip_smoke.attention_bounds(B, S, H, D)
    pairs = B * H * S * (S + 1) // 2
    tensor = B * S * H * D * 2
    fwd_bytes = 4 * tensor + B * H * S * 4  # q, k, v, o in bf16; lse in f32
    bwd_flops = 10 * D * pairs  # five causal products, 2 FLOP per MAC
    assert bounds["causal_attention_fwd"] == (pytest.approx(fwd_bytes / 3.35e12 * 1e3), "bytes")
    assert bounds["causal_attention_bwd"] == (pytest.approx(bwd_flops / 989e12 * 1e3), "operations")


def test_attention_flops_at_gpt2_shape():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, D = chip_smoke.SLICE_ATTN
    # Q K^T and P V, 2 FLOP per multiply-add, over the S(S+1)/2 causal pairs
    assert chip_smoke.attention_flops(B, S, H, D) == 2 * 2 * D * B * H * S * (S + 1) // 2
    ops_ms = chip_smoke.attention_flops(B, S, H, D) / 989e12 * 1e3
    assert chip_smoke.attention_bounds(B, S, H, D)["causal_attention_fwd"][0] >= ops_ms


def test_backward_flops_give_the_backward_bound():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, S, H, D = chip_smoke.SLICE_ATTN
    # five products (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) over the causal pairs
    flops = chip_smoke.attention_flops(B, S, H, D, products=5)
    assert flops == 2 * 5 * D * B * H * S * (S + 1) // 2
    assert chip_smoke.attention_bounds(B, S, H, D)["causal_attention_bwd"][0] == pytest.approx(flops / 989e12 * 1e3)
