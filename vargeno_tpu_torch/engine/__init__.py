"""The batched genotyping engine on a torch device."""
