"""Operations and bytes of each model family, one module a family."""
