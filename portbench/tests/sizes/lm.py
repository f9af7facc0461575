"""The LM at a size the CPU serves: 2 layers of the published block
(QK-norm, 8 experts top 2, dropless) at d_model 64, a vocabulary of 503,
a pool of 8 prompts of 5-13 tokens; a cell's 2 clients, 8 new tokens
each in a pool of 2 slots, every request kept.

The check's limits scale with the precision the model runs at: bf16
through 2 layers leaves a token's logits about 0.009 of the median row
norm off the float32 reference (48 layers on the card: about 0.05), so
the tiny model is held to limits of its own, set as the configuration's
are, between the sound program's readings and the faults'."""

TINY_LM = {"hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "vocab_size": 503, "num_experts": 8,
           "num_experts_per_tok": 2, "moe_intermediate_size": 32,
           "prompt_tokens": [5, 13], "pool": 8, "bad_token": 0.02,
           "limits": {"token_err_median": 0.018, "bad_token_share": 0.2}}


def shrink(config, config_dir) -> None:
    config.update(TINY_LM)


def shrink_cell(cell) -> None:
    cell["traffic"]["clients"] = 2
    cell["engine"].update(max_batch=2, max_len=24, max_new_tokens=8)
    cell["check"].update(keep_run=1, keep_every=1)
