"""The port's hand-written CUDA kernels, each behind a wrapper that runs its
plain PyTorch version on CPU tensors and counts its launches on the card
in ``<wrapper>.launches`` (K8 / K9 also by vec, in ``<wrapper>.by_vec``)."""


def wrappers() -> tuple:
    """Every kernel wrapper, K1 to K11 (imported here, not at package
    import: the modules build their libraries lazily)."""
    from qpalette_tpu_torch.kernels import (arith, arith_dequant, int8_gemv,
                                            tcq_lut, vq)
    return (arith.KERNELS + arith_dequant.KERNELS + tcq_lut.KERNELS
            + vq.KERNELS + int8_gemv.KERNELS)


def launch_counts() -> dict:
    """{wrapper name: its launch count}."""
    return {f.__name__: f.launches for f in wrappers()}


def reset_launches() -> None:
    """Set every launch count to 0, the counts by vec included."""
    for f in wrappers():
        f.launches = 0
        for vec in getattr(f, "by_vec", ()):
            f.by_vec[vec] = 0
