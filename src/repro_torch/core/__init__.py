"""Host-side model of the memristor array: encoding, oracle, cost model."""
