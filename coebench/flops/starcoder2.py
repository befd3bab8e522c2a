"""StarCoder2: FLOPs of a served prompt and ``flash_attention`` launches of
a forward, from shapes."""
from coebench import roofline


def prompt_flops(cfg: dict, s: int) -> float:
    """Every layer's four attention products and two MLP products at every
    position, causal attention (QK and PV over the visible pairs), the LM
    head at the last position only. Norms, RoPE, GELU and the embedding
    lookup are not counted."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    hkv = cfg["num_key_value_heads"]
    hd = d // h
    ff = cfg["intermediate_size"]
    per_token = (2 * d * h * hd + 2 * 2 * d * hkv * hd + 2 * h * hd * d
                 + 2 * 2 * d * ff)
    attn = 4 * h * hd * roofline.causal_pairs(
        s, s, cfg.get("sliding_window") or 0)
    return cfg["num_hidden_layers"] * (s * per_token + attn) \
        + 2 * d * cfg["vocab_size"]


def launches(cfg: dict, rows: int, s: int) -> dict:
    """One causal self-attention launch a layer over the padded batch."""
    h = cfg["num_attention_heads"]
    return {"flash_attention": (cfg["num_hidden_layers"],
                                roofline.flash_attention_launch(
                                    rows, h, cfg["num_key_value_heads"], s,
                                    cfg["hidden_size"] // h,
                                    cfg["served_dtype"],
                                    cfg.get("sliding_window") or 0))}
