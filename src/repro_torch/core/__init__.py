"""Core of the port: topology, NoC and deadlock analysis (copies of the
reference's pure-Python modules), routing tables, telemetry, dispatch and
the topology compiler."""
