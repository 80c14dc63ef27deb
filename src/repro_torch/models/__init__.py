"""Models of the port: dense GQA language models (the serving slice).

  layers       -- param specs, ParamTree, rms_norm, rope, SwiGLU MLP
  attention    -- GQA attention: dense and flash, ring caches, decode
  transformer  -- the layer stack, scanned or unrolled
  model        -- LanguageModel: prefill / decode_step
  convert      -- parameters of the JAX package into the port's layout
"""
