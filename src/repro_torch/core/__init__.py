"""AdaOper core of the port: the energy ledger, op graphs, the device
simulator, the runtime energy profiler (GBDT + GRU corrector) and the DP
operator partitioner."""
