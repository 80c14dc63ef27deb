"""Models of the port: dense GQA, mixture-of-experts, Mamba-2 and
RecurrentGemma language models.

  layers       -- param specs (with layer provenance), ParamTree, rms_norm,
                  rope, SwiGLU MLP
  attention    -- GQA attention: dense and flash, ring caches, decode
  moe          -- capacity-dispatch MoE, and expert parallelism over ranks
  transformer  -- the layer stack, scanned or unrolled, remat
  model        -- LanguageModel: train_loss / prefill / decode_step
  xent         -- the fused linear cross-entropy
  convert      -- parameters of the JAX package into the port's layout
"""
