"""Server entry points of the port (`tutoring_server`)."""
