"""Language models of the port (GPT, Llama) and their decode caches."""
from .generation import DecodeCache, update_and_attend
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = ["DecodeCache", "update_and_attend", "GPTConfig",
           "GPTForCausalLM", "GPTModel", "LlamaConfig", "LlamaForCausalLM",
           "LlamaModel"]
