"""Zero-shot multiple-choice evaluation (lm-eval's loglikelihood protocol).

Counterpart of ``qpalette_tpu/runtime/zeroshot.py``: every answer of a
question is scored by the summed log-probability of its tokens after the
question (acc), and by that sum over the answer's UTF-8 byte length
(acc_norm); the argmax is the model's pick.  The tokenizer is the
caller's (``tok(text, add_special_tokens=...).input_ids``).  Task data
comes from the local Hugging Face datasets cache (``datasets`` is
imported when called).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from qpalette_tpu_torch.models import llama


@torch.inference_mode()
def _token_logprobs(spec, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> the log-probability of each next token (B, S-1),
    float32."""
    logits = llama.forward(spec, params, tokens)
    logp = torch.log_softmax(logits[:, :-1, :], dim=-1)
    return logp.gather(-1, tokens[:, 1:, None])[..., 0]


def loglikelihood(spec, params, tokenizer, context: str, continuation: str,
                  max_len: int = 1024) -> Tuple[float, int]:
    """(summed log-probability of the continuation's tokens given the
    context, their count); context and continuation together are cut to
    their last max_len tokens."""
    ctx_ids = tokenizer(context, add_special_tokens=True).input_ids
    cont_ids = tokenizer(continuation, add_special_tokens=False).input_ids
    ids = (ctx_ids + cont_ids)[-max_len:]
    n_cont = len(cont_ids)
    tokens = torch.as_tensor(np.asarray(ids)[None, :], dtype=torch.int64,
                             device=params["embed"].device)
    lp = _token_logprobs(spec, params, tokens)[0].cpu().numpy()
    return float(lp[-n_cont:].sum()), n_cont


def eval_multiple_choice(spec, params, tokenizer,
                         examples: List[dict]) -> Dict[str, float]:
    """examples: [{"query": str, "choices": [str], "gold": int}] ->
    {"acc", "acc_norm", "n"}; ties go to the first choice (np.argmax)."""
    correct = correct_norm = 0
    for ex in examples:
        scores, norm_scores = [], []
        for ch in ex["choices"]:
            s, _ = loglikelihood(spec, params, tokenizer, ex["query"], ch)
            scores.append(s)
            norm_scores.append(s / max(len(ch.encode()), 1))
        if int(np.argmax(scores)) == ex["gold"]:
            correct += 1
        if int(np.argmax(norm_scores)) == ex["gold"]:
            correct_norm += 1
    n = len(examples)
    return {"acc": correct / n, "acc_norm": correct_norm / n, "n": n}


def _load(name, *cfg, split="validation"):
    from datasets import load_dataset
    return load_dataset(name, *cfg, split=split)


def task_examples(task: str, limit=None) -> List[dict]:
    """arc_easy, arc_challenge, piqa, winogrande or hellaswag in the
    format of eval_multiple_choice (local cache only)."""
    if task in ("arc_easy", "arc_challenge"):
        cfg = "ARC-Easy" if task == "arc_easy" else "ARC-Challenge"
        ds = _load("allenai/ai2_arc", cfg, split="test")
        out = []
        for ex in ds:
            labels = ex["choices"]["label"]
            gold = labels.index(ex["answerKey"])
            out.append({"query": f"Question: {ex['question']}\nAnswer:",
                        "choices": [" " + t for t in ex["choices"]["text"]],
                        "gold": gold})
    elif task == "piqa":
        ds = _load("piqa", split="validation")
        out = [{"query": f"Question: {ex['goal']}\nAnswer:",
                "choices": [" " + ex["sol1"], " " + ex["sol2"]],
                "gold": ex["label"]} for ex in ds]
    elif task == "winogrande":
        ds = _load("winogrande", "winogrande_xl", split="validation")
        out = []
        for ex in ds:
            pron = ex["sentence"].index("_")
            ctx = ex["sentence"][:pron]
            post = ex["sentence"][pron + 1:]
            out.append({"query": ctx,
                        "choices": [ex["option1"] + post,
                                    ex["option2"] + post],
                        "gold": int(ex["answer"]) - 1})
    elif task == "hellaswag":
        ds = _load("hellaswag", split="validation")
        out = [{"query": ex["ctx"],
                "choices": [" " + e for e in ex["endings"]],
                "gold": int(ex["label"])} for ex in ds]
    else:
        raise ValueError(task)
    if limit:
        out = out[:limit]
    return out
