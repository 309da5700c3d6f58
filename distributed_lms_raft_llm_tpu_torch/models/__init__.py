"""GPT-2 and Llama on plain tensors (`gpt2`, `llama`), the relevance
gate's BERT encoder (`bert`), their building blocks (`common`),
weight-only int8 (`quant`), weight conversion from HF safetensors and from
the JAX package (`convert`), and the serving preset table (`registry`)."""
