"""Gated linear recurrence scan h_t = a_t h_{t-1} + b_t (the RG-LRU inner
loop of RecurrentGemma's recurrent blocks)."""
