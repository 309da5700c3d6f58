"""Framework-free helpers, the port's own copies: tokenizers, metrics,
deadlines and admission errors, forwarding auth, the telemetry timeline
and the serving loop's watchdog."""
