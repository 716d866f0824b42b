"""Host helpers: bit writers and native builds."""
