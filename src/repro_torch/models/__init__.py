from repro_torch.models import convert, layers, model, nn, ssm

__all__ = ["convert", "layers", "model", "nn", "ssm"]
