"""Visual and instruction encoders."""
