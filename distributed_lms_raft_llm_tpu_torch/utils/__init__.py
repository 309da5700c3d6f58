"""Framework-free helpers, the port's own copies: tokenizers, metrics,
deadlines, breakers and admission errors, forwarding auth, network and
disk fault injection, PDF text, tracing, the telemetry timeline and the
watchdogs."""
