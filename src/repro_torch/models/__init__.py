"""The paper's benchmark models as ``nn.Module``s in the reference layout."""
