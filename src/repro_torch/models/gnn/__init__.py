"""GNNs of the port: GIN, GAT and PNA (MACE is not ported yet). Every
aggregation goes through ``common.segment_sum``, kernel B9."""
