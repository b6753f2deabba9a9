"""The SJPC stream monitor of the LM stack."""
