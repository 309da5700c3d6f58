"""Command-line tools over the port: the program-inventory and metrics-table
generators (`python -m ...tools.gen_program_inventory`, `...gen_metrics_table`),
the trace waterfall (`...trace_report`), the telemetry dashboard and
capacity model (`...telemetry`), the deployment's artifact builder
(`...make_local_checkpoint`, with its vocabulary trainers in `train_vocab`),
the decode profiler (`...profile_decode`) and the streaming descriptor
edit of `proto/lms_pb2.py` (`...regen_proto_stream`)."""
