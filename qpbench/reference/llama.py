"""Plain float32 reference of the decoder-only transformer the configurations
name (Mistral-7B-v0.3, DeepSeek-LLM-7B: pre-norm RMSNorm blocks, RoPE in
the rotate-half convention, grouped-query causal softmax attention, a
SiLU-gated MLP, no biases, an untied head), over quantized projections.

A projection y = Wscale * (W @ rotate(x, SU)): W decoded from its packed
words by its family's plain decoder (``decoders``), its rows scaled by
Wscale, its input rotated by the group's signs.  Merged groups stack
their projections' rows (qkv: q, k, v; ug: up, gate).  The head is the
configuration's head format, ``reference/heads/<head>.py``.  No cache and
no batching: every sequence runs whole, a layer at a time (each layer's
weights are decoded once for all sequences), on float32 with TF32 off.

``control`` runs the same arithmetic one precision step lower
(``precision.py``).

Inputs come from ``weights``, the draws the benchmark also hands to the
program; nothing is read from the program.
"""

from __future__ import annotations

import torch

from qpbench import files
from qpbench.reference import decoders
from qpbench.reference.precision import round_input, round_weight

HEAD_CHUNK = 8  # attention heads a chunk


def groups(config: dict) -> list:
    """[(group, [(projection, rows)], in_features, scheme, su name)] of
    one layer, in the order of the forward."""
    model, quant = config["model"], config["quantization"]
    h, d = model["hidden_size"], model["head_dim"]
    hq, hk = model["num_attention_heads"] * d, model["num_key_value_heads"] * d
    inter = model["intermediate_size"]
    rows = {"q": hq, "k": hk, "v": hk, "o": h, "up": inter, "gate": inter,
            "down": h}
    ins = {"q": h, "k": h, "v": h, "o": hq, "up": h, "gate": h,
           "down": inter}
    sus = {"q": "su_qkv", "k": "su_qkv", "v": "su_qkv", "o": "su_o",
           "up": "su_ug", "gate": "su_ug", "down": "su_dp"}
    merges = set(quant["merges"])
    if merges - {"qkv", "ug"}:
        raise NotImplementedError(f"merges {sorted(merges)}")
    order = ([["q", "k", "v"]] if "qkv" in merges else [["q"], ["k"], ["v"]])
    order += [["o"]]
    order += [["up", "gate"]] if "ug" in merges else [["up"], ["gate"]]
    order += [["down"]]
    out = []
    for members in order:
        name = {("q", "k", "v"): "qkv", ("up", "gate"): "ug"}.get(
            tuple(members), members[0])
        qstrs = {quant["projections"][p] for p in members}
        if len(qstrs) != 1:
            raise ValueError(f"group {name} merges {sorted(qstrs)}")
        out.append((name, [(p, rows[p]) for p in members], ins[members[0]],
                    decoders.scheme(qstrs.pop(), config["root"]),
                    sus[members[0]]))
    return out


def head(config: dict):
    """The module of the configuration's head format."""
    return files.load("reference/heads", config["quantization"]["head"],
                      config["root"])


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, d) at positions 0..S-1, rotate-half convention."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention: q (S, H, d), k/v (S, Hk, d) -> (S, H*d)."""
    s, heads, d = q.shape
    g = heads // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = []
    for h0 in range(0, heads, HEAD_CHUNK):
        qh = q[:, h0:h0 + HEAD_CHUNK].transpose(0, 1) * d ** -0.5
        kh = k[:, h0:h0 + HEAD_CHUNK].transpose(0, 1)
        vh = v[:, h0:h0 + HEAD_CHUNK].transpose(0, 1)
        logits = (qh @ kh.transpose(1, 2)).masked_fill(~mask, float("-inf"))
        out.append(torch.softmax(logits, dim=-1) @ vh)
    return torch.cat(out, dim=0).transpose(0, 1).reshape(s, heads * d)


class Reference:
    """The reference model of one configuration over the benchmark's
    draws; ``hidden`` runs sequences to the final norm, ``logits`` applies
    the head to rows of hidden states."""

    def __init__(self, config: dict, weights, control=None):
        self.config = config
        self.model = config["model"]
        self.weights = weights
        self.control = control
        self.groups = groups(config)
        self.head = head(config)

    @torch.no_grad()
    def hidden(self, seqs: list) -> list:
        """token id tensors (S_i,) -> final-norm hidden states (S_i, h)
        float32."""
        md, w = self.model, self.weights
        h, d, eps = md["hidden_size"], md["head_dim"], md["rms_norm_eps"]
        heads, kv_heads = md["num_attention_heads"], md["num_key_value_heads"]
        embed = w.embed()
        xs = [embed[s].float() for s in seqs]
        del embed
        for layer in range(md["num_hidden_layers"]):
            outs = {}
            mats = {}
            for name, members, n, scheme, su in self.groups:
                m = sum(r for _, r in members)
                words, wscale = w.group(layer, name, scheme, m, n)
                w_dec = round_weight(decoders.decode(scheme, words, m, n),
                                     self.control)
                mats[name] = (w_dec, wscale, members, su)
            sus = {k: w.rotation_signs(layer, k) for k in
                   ("su_qkv", "su_o", "su_ug", "su_dp")}

            def project(name, x):
                w_dec, wscale, members, su = mats[name]
                z = round_input(decoders.rotate(x, sus[su]), self.control)
                y = (z @ w_dec.T) * wscale
                parts = torch.split(y, [r for _, r in members], dim=-1)
                return {p: t for (p, _), t in zip(members, parts)}

            new = []
            for x in xs:
                s = x.shape[0]
                hn = rms_norm(x, eps)
                for name in [g[0] for g in self.groups
                             if g[1][0][0] in ("q", "k", "v")]:
                    outs.update(project(name, hn))
                q = rope(outs["q"].reshape(s, heads, d), md["rope_theta"])
                k = rope(outs["k"].reshape(s, kv_heads, d), md["rope_theta"])
                v = outs["v"].reshape(s, kv_heads, d)
                x = x + project("o", attention(q, k, v))["o"]
                hn = rms_norm(x, eps)
                for name in [g[0] for g in self.groups
                             if g[1][0][0] in ("up", "gate")]:
                    outs.update(project(name, hn))
                act = torch.nn.functional.silu(outs["gate"]) * outs["up"]
                new.append(x + project("down", act)["down"])
            xs = new
            del mats
        return [rms_norm(x, eps) for x in xs]

    @torch.no_grad()
    def logits(self, hid: torch.Tensor) -> torch.Tensor:
        """hidden rows (P, h) -> (P, vocab) float32."""
        return self.head.logits(self, hid)
