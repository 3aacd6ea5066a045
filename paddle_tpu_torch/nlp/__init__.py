"""Language models of the port (GPT) and their paged decode cache."""
from .generation import DecodeCache, update_and_attend
from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["DecodeCache", "update_and_attend", "GPTConfig",
           "GPTForCausalLM", "GPTModel"]
