"""Graph application of the port: Dijkstra on the TNS engines (§3.1)."""
