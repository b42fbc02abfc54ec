"""Decoder model: layers, attention with pluggable decode backends, the
stack's prefill/decode entry points and the weight bridge."""
