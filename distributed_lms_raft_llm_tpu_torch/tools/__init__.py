"""Command-line tools over the port: the program-inventory and metrics-table
generators (`python -m ...tools.gen_program_inventory`, `...gen_metrics_table`),
the trace waterfall (`...trace_report`) and the telemetry dashboard and
capacity model (`...telemetry`)."""
