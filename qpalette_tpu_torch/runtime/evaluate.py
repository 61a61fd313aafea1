"""Perplexity evaluation.

Counterpart of ``qpalette_tpu/runtime/evaluate.py``: the mean next-token
cross-entropy of ctx-size windows of a token stream, ppl = exp(mean).
The head runs over sequence chunks, so a ctx-8192 window never holds the
whole (B, S, vocab) float32 logits (4.2 GB at Llama-3's vocab); the
forward's attention goes blockwise at that length (models/llama.py
_attention_flash).  The dataset loaders need the local Hugging Face cache
(``datasets`` and ``transformers`` are imported when called).
"""

from __future__ import annotations

import numpy as np
import torch

from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.runtime.qlinear import qlinear_apply


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed -log p(target) of float32 logits (..., vocab)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).sum()


@torch.inference_mode()
def ce_loss(spec, params, tokens: torch.Tensor,
            chunk: int = 1024) -> torch.Tensor:
    """tokens (B, S) int64 on the model's device -> the mean next-token
    cross-entropy over B * (S - 1) targets, a 0-d float32 tensor.

    The head takes ``chunk`` positions at a time.  The 4-bit trellis head
    runs qlinear_apply at the hidden state's bf16 and is cast to float32
    after, so its logits are rounded to bf16 before the log-softmax (the
    reference's ce_loss does so; its forward asks for float32 logits).
    The int8 head is the float32 weights q * s, made once a call, with
    the chunk rotated by ``lm_head_su`` where the head has one and the pad
    columns dropped before the softmax; the bf16 head is made float32
    once a call."""
    h = llama.forward(spec, params, tokens, return_hidden=True)
    vocab = spec.config.vocab_size
    B, S = tokens.shape
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    if spec.lm_head_spec is not None:
        for c0 in range(0, S - 1, chunk):
            c1 = min(c0 + chunk, S - 1)
            hc = h[:, c0:c1].reshape(-1, h.shape[-1])
            logits = qlinear_apply(spec.lm_head_spec, params["lm_head_q4"],
                                   hc, pre_rot=params["lm_head_su"],
                                   luts=params.get("luts"))
            logits = logits.float()[:, :vocab].reshape(B, c1 - c0, vocab)
            total += _nll_sum(logits, tokens[:, c0 + 1:c1 + 1])
        return total / (B * (S - 1))
    su = None
    if "lm_head_q" in params:
        lm = (params["lm_head_q"][:vocab].float()
              * params["lm_head_s"][:vocab, None].float())
        su = params.get("lm_head_su")
    else:
        lm = params["lm_head"][:vocab].float()
    for c0 in range(0, S - 1, chunk):
        c1 = min(c0 + chunk, S - 1)
        hc = h[:, c0:c1]
        if su is not None:
            hc = llama._rotate_in(hc, su.to(hc.dtype))
        logits = hc.float() @ lm.T
        total += _nll_sum(logits, tokens[:, c0 + 1:c1 + 1])
    return total / (B * (S - 1))


def eval_ppl(spec, params, token_stream, ctx_size: int = 8192,
             progress: bool = True):
    """token_stream: flat integer array.  Its len // ctx_size windows, one
    ce_loss each; returns (ppl, avg_loss) as floats."""
    device = params["embed"].device
    stream = np.asarray(token_stream)
    n = len(stream) // ctx_size
    total = 0.0
    for i in range(n):
        window = stream[i * ctx_size:(i + 1) * ctx_size]
        tokens = torch.as_tensor(window[None, :], dtype=torch.int64,
                                 device=device)
        total += float(ce_loss(spec, params, tokens))
        if progress:
            print(f"  [{i + 1}/{n}] avg_loss={total / (i + 1):.4f}",
                  flush=True)
    avg = total / max(n, 1)
    return float(np.exp(avg)), avg


def _tokenize(texts, tokenizer_name, joiner):
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(tokenizer_name)
    return np.asarray(tok(joiner.join(texts),
                          return_tensors="np").input_ids[0])


def wikitext2_tokens(tokenizer_name: str = "meta-llama/Llama-3.1-8B",
                     split: str = "test"):
    """WikiText-2 raw, its texts joined by blank lines and tokenized.
    Needs the dataset and the tokenizer in the local cache: without them
    ``datasets`` / ``transformers`` raise."""
    from datasets import load_dataset
    ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    return _tokenize(ds["text"], tokenizer_name, "\n\n")


def ptb_tokens(tokenizer_name: str = "meta-llama/Llama-3.1-8B",
               split: str = "test"):
    """The PTB test stream (local cache only)."""
    from datasets import load_dataset
    ds = load_dataset("ptb_text_only", "penn_treebank", split=split)
    return _tokenize(ds["sentence"], tokenizer_name, " ")


def c4_tokens(tokenizer_name: str = "meta-llama/Llama-3.1-8B",
              n_docs: int = 1100):
    """The first n_docs of C4's first validation shard (local cache
    only)."""
    from datasets import load_dataset
    ds = load_dataset("allenai/c4", "en",
                      data_files={"validation":
                                  "en/c4-validation.00000-of-00008.json.gz"},
                      split="validation")
    return _tokenize([ds[i]["text"] for i in range(min(n_docs, len(ds)))],
                     tokenizer_name, " ")


DATASET_LOADERS = {"wikitext2": wikitext2_tokens, "ptb": ptb_tokens,
                   "c4": c4_tokens}
