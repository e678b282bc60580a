"""Continuous-batching serving engine of the port, FIFO or AdaOper-scheduled."""
