"""Small copies of the benchmark's configurations for CPU tests: the
published files with their widths cut, the same keys and deviations."""
import copy

from perfkit import manifest

MIX = manifest.load_json(manifest.BENCH / "traffic" / "dp-train-4k.json")


def conf(name: str, dtype: str = "float32") -> dict:
    c = copy.deepcopy(manifest.load_json(
        manifest.BENCH / "configs" / f"{name}.json"))
    if "kv_lora_rank" in c:
        c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                 kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                 v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=32, n_shared_experts=1,
                 intermediate_size=96, vocab_size=128, num_hidden_layers=3)
    else:
        c.update(hidden_size=64, num_attention_heads=8, num_key_value_heads=2,
                 intermediate_size=96, vocab_size=128, num_hidden_layers=2)
    c["dtype"] = dtype
    return c


def cell(name: str, dtype: str = "float32", *, chips: int = 1,
         rows: int = 2, seq: int = 32, limits=None) -> dict:
    mix = dict(MIX, seq_len=seq)
    return {"name": f"tiny.{name}", "conf": conf(name, dtype), "mix": mix,
            "chips": chips, "end_to_end": [], "per_layer": [],
            "sizing": {"batch_per_chip": rows, "limits": limits or {}}}


CONFIGS = ("deepseek-coder-33b.l4", "deepseek-v2-lite-16b.l4")
