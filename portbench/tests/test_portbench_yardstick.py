"""The frozen yardstick: the token generator's bytes for a seed, and the
FLOP, operation and byte counts against counts made by hand."""
import hashlib
import math

from portbench.tests import threads  # noqa: F401
from portbench import tokens, yardstick


def test_token_stream_golden_bytes():
    a = tokens.token_stream(5000, 32000, seed=7)
    assert a[:8].tolist() == [16212, 1644, 11493, 11984, 15169, 23482,
                              28885, 18858]
    assert hashlib.sha256(a.tobytes()).hexdigest() == \
        "22bcacf76b25c3566228d2dbb3cfdedb525f3597a7b7db173a2bb408c68c360d"
    b = next(tokens.lm_batches(a, 2, 64, seed=7))
    assert hashlib.sha256(b["tokens"].tobytes() + b["labels"].tobytes()) \
        .hexdigest() == \
        "275a69b176b27230f6f9754c0c634ecd4665fd3a56595a2b9d68f884704711ec"
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


def test_seed_folds_past_32_bits():
    assert tokens.seed32(2 ** 32 + 5) == 5
    assert tokens.seed32(2 ** 31 + 3) == 2 ** 31 + 3


def test_causal_pairs_by_enumeration():
    for S, W in [(7, None), (7, 3), (8, 8), (8, 20), (16, 5)]:
        n = sum(1 for q in range(S) for k in range(S)
                if k <= q and (W is None or k > q - W))
        assert yardstick.causal_pairs(S, W) == n


MOE = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
       "d_ff": 16, "vocab_size": 100, "n_layers": 2,
       "layer_pattern": ["local"], "window": 3, "mlp": "swiglu",
       "n_experts": 4, "experts_per_token": 2}
RWKV = {"d_model": 8, "n_heads": 2, "n_kv_heads": 2, "d_ff": 16,
        "vocab_size": 100, "n_layers": 3, "layer_pattern": ["rwkv"],
        "mlp": "gelu", "rwkv_head_dim": 4, "rwkv_lora_rank": 2}


def test_moe_forward_flops_by_hand():
    S = 5
    # q 8x8, k and v 8x4 each, o 8x8: 2 * (64 + 32 + 32 + 64)
    proj = 2 * (8 * 8 + 8 * 4 + 8 * 4 + 8 * 8)
    # window 3 over 5 positions: 1 + 2 + 3 + 3 + 3 keys
    scores = 4 * 2 * 4 * (12 / 5)
    # router 8 -> 4, then 2 experts of three 8x16 products each
    ffn = 2 * 8 * 4 + 2 * 3 * 2 * 8 * 16
    head = 2 * 8 * 100
    want = 2 * (proj + scores + ffn) + head
    assert math.isclose(yardstick.forward_flops_per_token(MOE, S), want)
    assert math.isclose(yardstick.train_flops_per_token(MOE, S), 3 * want)


def test_rwkv_forward_flops_by_hand():
    # r k v g o: five 8x8 products; the decay's 8x2 and 2x8; two heads
    # of 4: 5 * 16 + 4 * 4 each; a gelu MLP's two 8x16 products
    layer = 5 * 2 * 64 + 2 * 16 + 2 * 16 + 2 * (5 * 16 + 16) \
        + 2 * 2 * 8 * 16
    want = 3 * layer + 2 * 8 * 100
    assert math.isclose(yardstick.forward_flops_per_token(RWKV, 9), want)


def test_kernel_counts_by_hand():
    # attention: B 1, S 4, 2 heads over 1 kv head of 8, no window:
    # 10 pairs, 4 * 8 operations each a head; q and o 2 heads, k and v 1
    ops, nbytes = yardstick.swa_attention_cost(1, 4, 2, 1, 8, None)
    assert ops == 4 * 8 * 2 * 10
    assert nbytes == 2 * 4 * 8 * (2 + 2 + 1 + 1)
    # WKV: B 2, T 3, 1 head of 4: 5 * 16 + 16 a step; r k v logw y fp32
    ops, nbytes = yardstick.wkv6_cost(2, 3, 1, 4)
    assert ops == 2 * 3 * (5 * 16 + 16)
    assert nbytes == 4 * (5 * 2 * 3 * 4 + 4)
    # AdamW over a bf16 leaf of 10: g, p, u 2 bytes; m, v read and written
    assert yardstick.adamw_bytes(10, "bfloat16", "bfloat16") == 10 * 22
    assert yardstick.adamw_bytes(10, "float32", "float32") == 10 * 28


def test_least_time_takes_the_larger_bound():
    assert yardstick.least_time(989e12, 0, 989e12) == 1.0
    assert yardstick.least_time(0, 3.35e12, 989e12) == 1.0
    assert yardstick.least_time(989e12, 6.7e12, 989e12) == 2.0
