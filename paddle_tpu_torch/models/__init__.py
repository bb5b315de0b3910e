"""Models of the port."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTKVCache, GPTModel,
                  GPTStackedTransformer,
                  GPTPretrainingCriterion,
                  gpt2_large, gpt2_medium, gpt2_small, gpt3_1p3b, gpt_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTKVCache", "GPTModel",
           "GPTStackedTransformer",
           "GPTPretrainingCriterion",
           "gpt2_large", "gpt2_medium", "gpt2_small", "gpt3_1p3b",
           "gpt_tiny"]
