"""The benchmark's model FLOPs and staging bytes against hand counts."""
from perfkit import flops


def test_dense_flops_by_hand():
    conf = {"hidden_size": 8, "num_attention_heads": 2,
            "num_key_value_heads": 1, "intermediate_size": 16,
            "vocab_size": 10, "num_hidden_layers": 2}
    # per layer: q 8x8, k and v 8x4 each, o 8x8, FFN 3 x 8x16
    per_layer = 64 + 32 + 32 + 64 + 384
    assert flops.matmul_params_per_token(conf) == 2 * per_layer + 80
    # seq 4: 10 query-key pairs, 2 heads, qk and v width 4: 2*(4+4) FLOP
    # a pair a head, 2 layers, over 4 tokens
    assert flops.attention_fwd_flops_per_token(conf, 4) == 2 * 2 * 16 * 10 / 4
    assert flops.train_flops_per_token(conf, 4) == \
        6 * (2 * per_layer + 80) + 3 * 160


def test_mla_moe_flops_by_hand():
    conf = {"hidden_size": 8, "num_attention_heads": 2,
            "num_key_value_heads": 2, "kv_lora_rank": 4,
            "qk_nope_head_dim": 3, "qk_rope_head_dim": 2, "v_head_dim": 3,
            "q_lora_rank": None, "n_routed_experts": 4,
            "num_experts_per_tok": 2, "n_shared_experts": 1,
            "moe_intermediate_size": 5, "first_k_dense_replace": 1,
            "intermediate_size": 6, "vocab_size": 10,
            "num_hidden_layers": 2}
    attn = 8 * 2 * 5 + 8 * (4 + 2) + 4 * 2 * (3 + 3) + 2 * 3 * 8
    dense = attn + 3 * 8 * 6
    moe = attn + 8 * 4 + (2 + 1) * 3 * 8 * 5
    assert flops.matmul_params_per_token(conf) == dense + moe + 80
    assert flops.attention_fwd_flops_per_token(conf, 2) == \
        2 * 2 * 2 * (5 + 3) * 3 / 2


def test_staging_bytes_by_hand():
    sizes = [10, 6, 4]
    dtypes = ["bfloat16", "bfloat16", "float32"]
    got = flops.staging_launches([[0, 1], [2]], ["ar", "ar"], [1, 1],
                                 [0, 0], sizes, dtypes, 1)
    assert got == [("bucket_pack", 32 + 64), ("convert_copy", 64 + 32),
                   ("bucket_pack", 16 + 16), ("convert_copy", 20 + 40),
                   ("convert_copy", 12 + 24)]
    # a fused bucket of 16 elements in 3 chunks over 4 ranks: chunks of
    # 5, 5, 6 padded to 8 each
    got = flops.staging_launches([[0, 1]], ["rs_ag"], [3], [1], [10, 6],
                                 ["bfloat16", "float32"], 4)
    assert got == [("fused_pack", 44 + 4 * 24), ("fused_unpack", 64 + 44),
                   ("convert_copy", 20 + 40)]
