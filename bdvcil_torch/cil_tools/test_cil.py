"""Test every per-task checkpoint of a CIL run (the counterpart of cil_tools/test_cil.py): not ported yet, ROADMAP A.7."""

from . import deferred_tool

main = deferred_tool("test_cil")

if __name__ == "__main__":
    main()
