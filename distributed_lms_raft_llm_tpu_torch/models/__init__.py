"""GPT-2 on plain tensors (`gpt2`), its building blocks (`common`), weight
conversion from HF safetensors and from the JAX package (`convert`), and
the preset table (`registry`)."""
