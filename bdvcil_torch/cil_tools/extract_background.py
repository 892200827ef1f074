"""Extract the temporal-median backgrounds of a rawframe tree (the counterpart of cil_tools/extract_background.py): not ported yet, ROADMAP A.7."""

from . import deferred_tool

main = deferred_tool("extract_background")

if __name__ == "__main__":
    main()
