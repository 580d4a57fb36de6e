"""Static plan checks (port of the parts of ``repro.verify`` the
lowering needs: the activation domain-transition table)."""
