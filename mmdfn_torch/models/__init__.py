"""The multimodal ERC model and its graph families."""

from mmdfn_torch.models.dialogue_gnn import DialogueGNN

__all__ = ["DialogueGNN"]
