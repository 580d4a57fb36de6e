"""Data: the synthetic ECG generator and the FPGA preprocessing chain."""
