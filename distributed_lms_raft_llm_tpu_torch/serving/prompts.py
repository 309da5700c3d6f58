"""The tutoring prompt frame, shared by the server and by callers that
drive the engine without gRPC (the JAX package's template, verbatim)."""

# Frame the raw student query for an instruction-free base LM.
PROMPT_TEMPLATE = (
    "You are an intelligent assistant. Answer the following question clearly "
    "and concisely.\nQuestion: {query}\nAnswer:"
)
