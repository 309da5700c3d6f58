"""The tutoring prompt frames, shared by the server and by callers that
drive the engine without gRPC (the JAX package's templates, verbatim)."""

# Frame the raw student query for an instruction-free base LM.
PROMPT_TEMPLATE = (
    "You are an intelligent assistant. Answer the following question clearly "
    "and concisely.\nQuestion: {query}\nAnswer:"
)

# Follow-up turns of a tutoring session append to the running transcript
# (turn N's prompt + answer) instead of re-framing from scratch, so the
# session's token prefix is byte-stable across turns and the radix prefix
# cache can splice turn N's KV blocks under turn N+1's prompt.
FOLLOWUP_TEMPLATE = "\nQuestion: {query}\nAnswer:"
