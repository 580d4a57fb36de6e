"""Analog substrate: hardware constants, quantizers, noise model, VMM."""
