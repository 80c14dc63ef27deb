"""How each traffic kind is run, one module a kind."""
