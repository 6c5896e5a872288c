"""Cells cut to a size the CPU tests can hold: the same files, with the
widths, depth, batch and lengths made small."""

from perfbench import harness

# Near the published width: a served token's logit gap scales with
# sqrt(hidden_size), and the limits are set at the published size.
LM_SMALL = dict(hidden_size=768, intermediate_size=1536, num_hidden_layers=2,
                num_attention_heads=12, num_key_value_heads=2, head_dim=64,
                vocab_size=4096)


def small_spec(workload: str) -> dict:
    spec = harness.load_cell(workload)
    t = spec["traffic"]
    t["pool"], t["warmup"] = 2, 1
    if spec["config"]["family"] == "lm":
        spec["config"].update(LM_SMALL)
        t["prompt_len"] = 16
        t["new_tokens"] = min(t["new_tokens"], 6)
        t["max_len"] = t["prompt_len"] + t["new_tokens"]
    else:
        t["batch"] = 8
    return spec


def run_small(workload: str, seed: int = 2**31 + 7, seconds: float = 0.0):
    import time

    return harness.run_cell(small_spec(workload), seed=seed, seconds=seconds,
                            trace=False, device="cpu",
                            t_start=time.perf_counter(), sync=lambda: None)
