"""The bf16 head in the program: ``params["lm_head"]``, the draw that the
reference's ``reference/heads/bf16.py`` multiplies too."""

from qpbench import files


def install(spec, params, config, draws):
    ref = files.load("reference/heads", "bf16", config["root"])
    params["lm_head"] = ref.weights(config, draws)["head"]
    return spec
