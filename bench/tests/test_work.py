"""The frozen counts against the published totals and against themselves."""
import json

import pytest

from smoke import config_path
from work.counts import Shape, peaks


def shape(name):
    return Shape.from_config(json.loads(config_path(name).read_text()))


def test_internlm_published_total():
    s = shape("internlm-1.8b")
    assert round(s.total_params / 1e9, 2) == 1.89          # "1.8B" / 1.89 B
    assert s.active_params == s.total_params
    assert s.kv_bytes_per_pos == 96 * 1024


def test_qwen2_moe_published_totals():
    s = shape("qwen2-moe-a2.7b")
    assert round(s.total_params / 1e9, 1) == 14.3
    assert round(s.active_params / 1e9, 2) == 2.69          # "A2.7B"
    assert s.kv_bytes_per_pos == 192 * 1024


@pytest.mark.parametrize("name", ["internlm-1.8b", "qwen2-moe-a2.7b"])
def test_config_file_states_its_totals(name):
    c = json.loads(config_path(name).read_text())
    s = Shape.from_config(c)
    assert c["parameters"]["total"] == s.total_params
    assert c["parameters"].get("active", s.total_params) == s.active_params


@pytest.mark.parametrize("start,n", [(0, 1), (0, 256), (256, 37), (4000, 96)])
def test_chunk_flops_is_the_sum_of_its_tokens(start, n):
    s = shape("internlm-1.8b")
    total = sum(s.token_flops(start + i, logits=(i == n - 1))
                for i in range(n))
    assert s.chunk_flops(start, n) == total


def test_a_token_at_position_zero_attends_one_key():
    s = shape("internlm-1.8b")
    assert s.token_flops(0, logits=False) == 2 * s.body_active \
        + 4 * 24 * 16 * 128
    assert s.token_flops(0, logits=True) - s.token_flops(0, logits=False) \
        == 2 * 2048 * 92544


def test_decode_bytes():
    s = shape("internlm-1.8b")
    # every weight once but the embedding, of which only the lanes' rows
    assert s.weight_bytes_step(32) == 2 * (s.total_params - 92544 * 2048
                                           + 32 * 2048)
    # a lane writing position 99 reads 99 positions and writes one
    assert s.decode_token_bytes(99) == 100 * s.kv_bytes_per_pos


def test_peaks_of_the_card():
    p = peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flop_s"] == 989e12 and p["hbm_byte_s"] == 3.35e12
    with pytest.raises(KeyError):
        peaks("a card nobody listed")
