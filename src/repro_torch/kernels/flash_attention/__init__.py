"""Flash attention (forward): blocked online-softmax GQA attention, the
attention kernel of every attention model's prefill."""
