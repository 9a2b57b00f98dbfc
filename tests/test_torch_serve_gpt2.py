"""GPT-2-shaped (learned positions, exact gelu, layernorm, biases) serving of the
PyTorch port against the JAX engines, on the CPU, in f32: the cases of
``serve_alibi_gpt2_cases.py`` (whose docstring says what each holds) for
this model."""

from serve_alibi_gpt2_cases import *  # noqa: F401,F403

KIND = "gpt2"
