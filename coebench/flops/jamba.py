"""Jamba: FLOPs of a served prompt and the ``mamba_scan``,
``flash_attention`` and ``moe_grouped`` launches of a forward, from shapes.

A held expert's rows are counted at their expected share: each token's
``num_experts_per_tok`` choices over ``router_experts``, of which this card
holds ``num_experts``, so k * held / E held choices a token (1 at
Jamba2-Mini's 2 * 8 / 16)."""
from coebench import roofline
from coebench.reference.jamba import pattern, sizes


def _held_rows(z: dict, tokens: int) -> float:
    return tokens * z["k"] * z["held"] / z["e"]


def prompt_flops(cfg: dict, s: int) -> float:
    """Every Mamba layer's in-, x-, dt- and out-projections, depthwise conv
    and scan (4 operations per channel and state), the attention layers'
    four products and causal attention (QK and PV over the visible pairs),
    the dense FFNs' three products, the MoE layers' router and held
    experts' three products at their expected share, at every position;
    the LM head at the last position only. Norms, the softplus, SiLU, the
    gates, the routing's sort and the embedding lookup are not counted."""
    z = sizes(cfg)
    d, h, hkv, hd, ff = z["d"], z["h"], z["hkv"], z["hd"], z["ff"]
    di, n, rk, w = z["di"], z["n"], z["rk"], z["w"]
    mamba = (2 * d * 2 * di + 2 * w * di + 2 * di * (rk + 2 * n)
             + 2 * rk * di + 4 * di * n + 2 * di * d)
    attn = 2 * d * h * hd + 2 * 2 * d * hkv * hd + 2 * h * hd * d
    swiglu = 2 * 3 * d * ff
    moe = 2 * d * z["e"] + _held_rows(z, 1) * swiglu
    slots = pattern(cfg)
    periods = z["layers"] // len(slots)
    total = 0.0
    for mixer, ffn in slots:
        per_token = (attn if mixer == "attn" else mamba) \
            + (moe if ffn == "moe" else swiglu)
        total += s * per_token
        if mixer == "attn":
            total += 4 * h * hd * roofline.causal_pairs(s, s)
    return periods * total + 2 * d * z["v"]


def moe_grouped_layer(cfg: dict, tokens: int) -> list:
    """The two launches of one MoE layer over ``tokens`` tokens, bf16:
    the gate/up launch reads the held experts' w_in once and its rows of x
    and writes h; the down launch reads w_down once and h and writes its
    rows of the result; 2 operations per multiply-add of the expected held
    rows at the tensor cores' bf16 rate."""
    z = sizes(cfg)
    d, ff, held = z["d"], z["ff"], z["held"]
    rows = _held_rows(z, tokens)
    b = roofline.DTYPE_BYTES[cfg["served_dtype"]]
    gate_up = roofline._bound(2 * rows * d * 2 * ff,
                              roofline.BF16_OPS_PER_S,
                              (held * d * 2 * ff + rows * (d + ff)) * b)
    down = roofline._bound(2 * rows * ff * d, roofline.BF16_OPS_PER_S,
                           (held * ff * d + rows * (ff + d)) * b)
    return [gate_up, down]


def launches(cfg: dict, rows: int, s: int) -> dict:
    """Over the padded batch: one scan launch a Mamba layer (x in the served
    dtype, dt, B and C in float32, as the program's Mamba block hands them
    to the kernel), one causal self-attention launch an attention layer,
    two grouped-expert launches an MoE layer (their mean bound each: the
    trace counts both under one name)."""
    z = sizes(cfg)
    slots = pattern(cfg)
    periods = z["layers"] // len(slots)
    mixers = [mixer for mixer, _ in slots]
    moe_layers = periods * sum(ffn == "moe" for _, ffn in slots)
    pair = moe_grouped_layer(cfg, rows * s)
    return {
        "mamba_scan": (periods * mixers.count("mamba"),
                       roofline.mamba_scan_launch(
                           rows, s, z["di"], z["n"], cfg["served_dtype"],
                           "float32", "float32")),
        "flash_attention": (periods * mixers.count("attn"),
                            roofline.flash_attention_launch(
                                rows, z["h"], z["hkv"], s, z["hd"],
                                cfg["served_dtype"])),
        "moe_grouped": (2 * moe_layers, {
            "bound_s": sum(p["bound_s"] for p in pair) / 2})}
